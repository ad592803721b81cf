"""Neural radiance caching (port of gfxexp_tpu/techniques/nrc): the
encodings, the online-trained MLP and the cache-terminated path tracer."""

from gfxexp_torch.techniques.nrc.network import (  # noqa: F401
    NRCConfig,
    NRCState,
    infer,
    init_nrc,
    nrc_state_from_jax,
    train_on_frame,
    train_step,
)
