from .optimizer import AdamWConfig, adamw_apply, adamw_init, cosine_lr, global_norm
from .train_step import cross_entropy, loss_fn, make_train_step
from .compress import (compress_with_feedback, compressed_pod_psum,
                       dequantize_int8, ef_init, quantize_int8)

__all__ = ["AdamWConfig", "adamw_apply", "adamw_init", "cosine_lr",
           "global_norm", "cross_entropy", "loss_fn", "make_train_step",
           "compress_with_feedback", "compressed_pod_psum", "dequantize_int8",
           "ef_init", "quantize_int8"]
