"""The segmentation front end: a 3D U-Net, its trainer and checkpoints, and
sliding-window inference (:mod:`convexadam_torch.models.segmentation`)."""

from convexadam_torch.models.segmentation import (
    UNet3D,
    blended_logits,
    dice_ce_loss,
    load_pretrained_unet3d,
    load_unet3d,
    make_predictor,
    save_unet3d,
    sliding_window_predict,
    train_unet3d,
)

__all__ = [
    "UNet3D",
    "blended_logits",
    "dice_ce_loss",
    "load_pretrained_unet3d",
    "load_unet3d",
    "make_predictor",
    "save_unet3d",
    "sliding_window_predict",
    "train_unet3d",
]
