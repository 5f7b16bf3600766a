"""Utilities of the port: sample grids, loss plots."""

from msig_tpu_torch.utils.grid import (  # noqa: F401
    add_text_to_image,
    save_image,
    save_sample_grid,
    to_uint8,
)
from msig_tpu_torch.utils.plotting import plot_losses, plot_weight_history  # noqa: F401
