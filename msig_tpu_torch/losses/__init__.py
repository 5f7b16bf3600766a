"""Loss functions of the port: LSGAN criteria + VGG19 perceptual style/content loss."""

from msig_tpu_torch.losses.criteria import l1_loss, lsgan_fake, lsgan_real  # noqa: F401
from msig_tpu_torch.losses.vgg import (  # noqa: F401
    VGGPrefix,
    get_vgg,
    init_random_vgg,
    load_vgg_params,
    style_content_loss,
    style_content_loss_pair,
    style_content_loss_pair2,
    vgg_features,
)
