"""Model zoo (PyTorch port of ``repro.models``): composable pattern-block
decoders (dense/MoE/SSM/hybrid/VLM)."""
from repro_torch.models.config import ModelConfig, MoEConfig, SSMConfig
from repro_torch.models.convert import params_from_reference
from repro_torch.models.transformer import (ParamTree, decode_step, forward,
                                            init_caches, init_params,
                                            loss_fn, prefill)

__all__ = ["ModelConfig", "MoEConfig", "SSMConfig", "ParamTree",
           "decode_step", "forward", "init_caches", "init_params", "loss_fn",
           "params_from_reference", "prefill"]
