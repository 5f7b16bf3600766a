"""Data layer of the port (counterpart of msig_tpu/data): domain discovery,
sampling, the host pipeline with its native decode core, and the
device-resident dataset."""

from msig_tpu_torch.data import native_loader  # noqa: F401
from msig_tpu_torch.data.dataset import (  # noqa: F401
    MultiDomainDataset,
    discover_inference_domains,
    discover_target_domains,
    list_image_files,
)
from msig_tpu_torch.data.device_data import DeviceData, make_augment_fn  # noqa: F401
from msig_tpu_torch.data.pipeline import (  # noqa: F401
    TrainLoader,
    load_inference_image,
    load_train_image,
    random_resized_crop_params,
)
