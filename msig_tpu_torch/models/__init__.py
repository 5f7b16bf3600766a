"""Torch modules of the port (counterpart of msig_tpu/models)."""

from msig_tpu_torch.models.networks import (  # noqa: F401
    AdaIN,
    AdaINResBlock,
    MultiDomainDiscriminator,
    MultiDomainStyleEncoder,
    StyleCycleGANGenerator,
)
