"""Evaluation of the port: FID (VGG-prefix proxy or canonical InceptionV3 pool3)
and the weights-free pixel statistics."""

from msig_tpu_torch.eval.fid import (  # noqa: F401
    activation_statistics,
    compute_fid,
    fid_between_dirs,
    frechet_distance,
    vgg_feature_fn,
)
from msig_tpu_torch.eval.inception import (  # noqa: F401
    InceptionV3Pool3,
    inception_feature_fn,
    inception_pool3,
    load_inception,
    load_inception_params,
)
from msig_tpu_torch.eval.pixel_stats import (  # noqa: F401
    color_frechet,
    color_texture_descriptor,
    hist_tv,
    pixel_metrics_between_dirs,
)
