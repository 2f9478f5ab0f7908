"""internlm2-1.8b [arXiv:2403.17297]: dense GQA LM.
24L d_model=2048 16H (kv=8) d_ff=8192 vocab=92544; head_dim = 2048/16 = 128."""
import functools

import torch

from repro_torch.configs import lm_common
from repro_torch.configs.lm_common import FAMILY, SHAPE_DEFS  # noqa: F401
from repro_torch.models.transformer import TransformerConfig

CFG = TransformerConfig(
    name="internlm2-1.8b", n_layers=24, d_model=2048, n_heads=16,
    n_kv_heads=8, d_ff=8192, vocab=92544, head_dim=128,
    param_dtype=torch.float32, compute_dtype=torch.bfloat16)

TRAIN = lm_common.TrainSetting(optimizer="adamw", accum=2)

build_smoke = functools.partial(lm_common.build_smoke, CFG, TRAIN)

ARCH = lm_common.make_arch("internlm2-1.8b", CFG, TRAIN)
