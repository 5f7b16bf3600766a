"""Host-side data helpers of the port (counterpart of msig_tpu/data)."""

from msig_tpu_torch.data.dataset import (  # noqa: F401
    MultiDomainDataset,
    discover_inference_domains,
    discover_target_domains,
    list_image_files,
)
from msig_tpu_torch.data.pipeline import (  # noqa: F401
    TrainLoader,
    load_inference_image,
    load_train_image,
    random_resized_crop_params,
)
