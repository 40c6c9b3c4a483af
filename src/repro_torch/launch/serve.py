"""Batched serving driver: the prompt through the KV cache, then decode.

The prompt is fed token by token through ``decode_step`` (teacher-forced,
filling the cache, as the reference's ``generate`` does), then
``max_new_tokens`` are sampled, or taken greedily, one decode step each.
Runs on the card unless ``--device cpu`` is given; without a card and
without it, it raises.  ``generate`` takes (B, Lp) text prompts: pixtral
generates from text alone, and the CLI refuses musicgen, whose codebook
tokens no sampler here takes, as the reference's does.

  python -m repro_torch.launch.serve --arch qwen2-0.5b --new-tokens 8
  python -m repro_torch.launch.serve --arch qwen2-0.5b --reduced --device cpu
  python -m repro_torch.launch.serve --arch falcon-mamba-7b --reduced --device cpu
  python -m repro_torch.launch.serve --arch qwen3-moe-235b-a22b --reduced --device cpu
  python -m repro_torch.launch.serve --arch deepseek-v2-236b --reduced --device cpu
  python -m repro_torch.launch.serve --arch pixtral-12b --reduced --device cpu
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_arch, reduced_config
from repro_torch.models import decode_step, init_cache, init_params

__all__ = ["generate", "main", "resolve_device"]


@torch.no_grad()
def generate(cfg, params, prompts: np.ndarray, max_new_tokens: int,
             temperature: float = 1.0, seed: int = 0,
             greedy: bool = False) -> np.ndarray:
    """prompts: (B, Lp) int32 (right-aligned, no padding).  Runs on the
    parameters' device; sampling draws from a ``torch.Generator`` there,
    seeded with ``seed``.  Returns (B, Lp + max_new_tokens) int32."""
    device = params["embed"]["table"].device
    B, Lp = prompts.shape
    cache = init_cache(cfg, B, Lp + max_new_tokens, device=device)
    toks = torch.as_tensor(np.asarray(prompts, np.int32), device=device)
    logits = None
    for t in range(Lp):
        logits, cache = decode_step(cfg, params, cache, {"tokens": toks[:, t:t + 1]})

    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    out = [toks]
    for _ in range(max_new_tokens):
        lf = logits[:, -1].float()
        if greedy or temperature <= 0:
            cur = torch.argmax(lf, dim=-1).to(torch.int32)[:, None]
        else:
            probs = torch.softmax(lf / temperature, dim=-1)
            cur = torch.multinomial(probs, 1, generator=gen).to(torch.int32)
        out.append(cur)
        logits, cache = decode_step(cfg, params, cache, {"tokens": cur})
    return torch.cat(out, dim=1).cpu().numpy()


def resolve_device(name: str | None) -> torch.device:
    """``name`` if given; else the card, and raise without one."""
    if name is not None:
        return torch.device(name)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu (with --reduced) "
                           "to run on the CPU")
    return torch.device("cuda")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=1.0)
    ap.add_argument("--device", default=None,
                    help="torch device; default the card, raising without one")
    args = ap.parse_args(argv)

    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = reduced_config(cfg)
    if cfg.frontend == "audio_codebooks":
        raise SystemExit("use the musicgen example for codebook decoding")
    device = resolve_device(args.device)
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    params = init_params(cfg, gen)
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab, size=(args.batch, args.prompt_len),
                           dtype=np.int32)
    t0 = time.time()
    out = generate(cfg, params, prompts, args.new_tokens,
                   temperature=args.temperature)
    dt = time.time() - t0
    total_new = args.batch * args.new_tokens
    print(f"[serve] arch={cfg.name} device={device} generated {out.shape} "
          f"({total_new / dt:.1f} tok/s incl. the prompt's decode steps)")
    print(out[:, args.prompt_len:][:2])


if __name__ == "__main__":
    main()
