"""Sharded, asynchronous, atomic checkpointing.

Layout per step:  <dir>/step_<k>/host_<i>.npz.<codec>  +  <dir>/step_<k>/DONE
                  <dir>/latest   (text pointer, written after DONE)
where <codec> is zst (zstandard, when installed) or zlib (stdlib fallback);
the DONE metadata records which codec committed the step.  The layout, the
array names (a leaf's path, ``a/b/0/c``) and the DONE JSON are the
reference's.

Design points:
  * each host serializes the tensors it holds (the API takes the host
    count; one host here);
  * ``save`` copies every tensor to host memory before it returns, so a
    step that later changes a tensor in place cannot reach the writer;
  * writes go to a temp name and are renamed — a reader never sees a torn
    file; the DONE marker commits the step atomically across files;
  * writing runs on a background thread (training continues; ``wait()``
    joins before the next save or at exit);
  * ``restore`` puts each array back in its template leaf's dtype and on
    its device; with ``shardings=`` (the elastic path, a tree of
    ``NamedSharding``s of the template's structure, ``None`` where a leaf
    is whole) each rank takes its own part of each array, on a mesh of any
    number of ranks.  Whoever writes a sharded state writes it whole: the
    ZeRO-1 trainer gathers its optimizer state and one rank writes host 0's
    file (``train.zero1.Zero1Checkpoints``), the reference's
    single-controller picture, so R ranks' checkpoint restores onto R';
  * ``max_to_keep`` garbage-collects old steps after commit.
"""
from __future__ import annotations

import io
import json
import pathlib
import shutil
import threading
import zlib

import numpy as np
import torch

from ..tree import flatten, unflatten

try:
    import zstandard
except ModuleNotFoundError:  # bare containers: stdlib zlib fallback
    zstandard = None

__all__ = ["CheckpointManager"]

# codec name -> (file extension, compress, decompress); the writer records
# its codec in the DONE metadata and the reader dispatches on the extension,
# so checkpoints stay readable across environments with/without zstandard
# (zstd payloads still need the module to restore — the error says so).
_CODECS = {
    "zstd": (".npz.zst",
             lambda b: zstandard.ZstdCompressor(level=3).compress(b),
             lambda b: zstandard.ZstdDecompressor().decompress(b)),
    "zlib": (".npz.zlib",
             lambda b: zlib.compress(b, 3),
             zlib.decompress),
}
_DEFAULT_CODEC = "zstd" if zstandard is not None else "zlib"
# float dtypes numpy holds; the others (bfloat16, the float8s) are widened to
# float32 for storage, which holds each of their values exactly
_NUMPY_FLOATS = (torch.float16, torch.float32, torch.float64)


def _host_copy(v) -> np.ndarray:
    """A numpy copy of a leaf that nothing else shares."""
    if isinstance(v, torch.Tensor):
        dt = v.dtype
        if dt.is_floating_point and dt not in _NUMPY_FLOATS:
            dt = torch.float32
        return v.detach().to(device="cpu", dtype=dt, copy=True).numpy()
    return np.array(v, copy=True)


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: int = 3,
                 host_id: int = 0, num_hosts: int = 1, async_save: bool = True,
                 codec: str = _DEFAULT_CODEC):
        if codec not in _CODECS:
            raise ValueError(f"unknown codec {codec!r}; have {sorted(_CODECS)}")
        if codec == "zstd" and zstandard is None:
            raise ValueError("codec 'zstd' requires the zstandard module")
        self.codec = codec
        self.dir = pathlib.Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.max_to_keep = max_to_keep
        self.host_id = host_id
        self.num_hosts = num_hosts
        self.async_save = async_save
        self._thread: threading.Thread | None = None

    # ------------------------------------------------------------------ save
    def save(self, step: int, tree) -> None:
        step = int(step)   # a 0-d tensor or np.int64 from a restored state
        self.wait()
        keys, leaves = flatten(tree)
        arrays = [_host_copy(v) for v in leaves]   # host copies before async

        def _write():
            step_dir = self.dir / f"step_{step:08d}"
            step_dir.mkdir(parents=True, exist_ok=True)
            buf = io.BytesIO()
            np.savez(buf, **{k: a for k, a in zip(keys, arrays)})
            ext, compress, _ = _CODECS[self.codec]
            payload = compress(buf.getvalue())
            tmp = step_dir / f"host_{self.host_id}{ext}.tmp"
            final = step_dir / f"host_{self.host_id}{ext}"
            tmp.write_bytes(payload)
            tmp.rename(final)
            # single-host container: host 0 commits
            if self.host_id == 0:
                (step_dir / "DONE").write_text(json.dumps(
                    {"step": step, "num_hosts": self.num_hosts,
                     "codec": self.codec}))
                (self.dir / "latest.tmp").write_text(str(step))
                (self.dir / "latest.tmp").rename(self.dir / "latest")
                self._gc()

        if self.async_save:
            self._thread = threading.Thread(target=_write, daemon=True)
            self._thread.start()
        else:
            _write()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[:-self.max_to_keep]:
            shutil.rmtree(self.dir / f"step_{s:08d}", ignore_errors=True)

    # --------------------------------------------------------------- restore
    def all_steps(self) -> list[int]:
        out = []
        for p in self.dir.glob("step_*"):
            if (p / "DONE").exists():
                out.append(int(p.name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> int | None:
        p = self.dir / "latest"
        if p.exists():
            s = int(p.read_text())
            if (self.dir / f"step_{s:08d}" / "DONE").exists():
                return s
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int, template, shardings=None):
        """Load into the template tree's structure: a tensor leaf comes back
        as a tensor of its template's dtype on its template's device, a
        numpy leaf in its dtype, anything else as the stored array.
        ``shardings``: a tree of the template's structure whose leaves are
        ``NamedSharding``s (``repro_torch.sharding``) or None; a leaf with
        one comes back as this rank's part of the stored array (its
        ``local`` at the rank's coordinate in the sharding's mesh).  Every
        rank reads and decompresses the whole file and keeps its parts."""
        step_dir = self.dir / f"step_{step:08d}"
        for name, (ext, _, decompress) in _CODECS.items():
            shard = step_dir / f"host_{self.host_id}{ext}"
            if shard.exists():
                if name == "zstd" and zstandard is None:
                    raise RuntimeError(f"{shard} is zstd-compressed but the "
                                       "zstandard module is not installed")
                break
        else:
            raise FileNotFoundError(f"no host_{self.host_id} shard in {step_dir}")
        raw = decompress(shard.read_bytes())
        npz = np.load(io.BytesIO(raw))
        keys, leaves = flatten(template)
        placed = [None] * len(keys)
        if shardings is not None:
            skeys, placed = flatten(shardings)
            if skeys != keys:
                raise ValueError("shardings= is not a tree of the template's structure")
        out = []
        for k, tmpl, at in zip(keys, leaves, placed):
            a = npz[k]
            if at is not None:
                a = np.ascontiguousarray(at.local(a))
            if isinstance(tmpl, torch.Tensor):
                a = torch.from_numpy(a).to(device=tmpl.device, dtype=tmpl.dtype)
            elif hasattr(tmpl, "dtype"):
                a = a.astype(tmpl.dtype)
            out.append(a)
        return unflatten(template, out)
