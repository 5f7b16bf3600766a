"""Host-side data helpers of the port (counterpart of msig_tpu/data)."""

from msig_tpu_torch.data.dataset import discover_inference_domains, list_image_files  # noqa: F401
from msig_tpu_torch.data.pipeline import load_inference_image  # noqa: F401
