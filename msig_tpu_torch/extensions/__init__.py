"""Extensions beyond the reference, off by default (counterpart of ``msig_tpu/extensions``).

The reference has none of these: no mapping network, no R1 penalty, no
diversity loss. At their defaults (no ``--mapping_params``, ``r1_gamma=0``)
the port computes exactly the reference's losses and styles.

  - :class:`MappingNetwork`: z -> a style code of each domain (latent-guided
    synthesis, a shared MLP and one head per domain);
  - :func:`r1_penalty`: the R1 gradient penalty on real images for the
    discriminator (``TrainConfig.r1_gamma > 0``).
"""

from msig_tpu_torch.extensions.mapping import MappingNetwork  # noqa: F401
from msig_tpu_torch.extensions.r1 import r1_penalty  # noqa: F401
