"""granite-3-2b [hf:ibm-granite/granite-3.0-2b-base]: dense GQA LM.
40L d_model=2048 32H (kv=8) d_ff=8192 vocab=49155; head_dim = 2048/32 = 64."""
import functools

import torch

from repro_torch.configs import lm_common
from repro_torch.configs.lm_common import FAMILY, SHAPE_DEFS  # noqa: F401
from repro_torch.models.transformer import TransformerConfig

CFG = TransformerConfig(
    name="granite-3-2b", n_layers=40, d_model=2048, n_heads=32,
    n_kv_heads=8, d_ff=8192, vocab=49155, head_dim=64,
    param_dtype=torch.float32, compute_dtype=torch.bfloat16)

build_smoke = functools.partial(lm_common.build_smoke, CFG)
