"""Evaluation metrics (byogan_tpu/eval/__init__.py): the multi-scale sliced
Wasserstein distance of the Progressive-GAN paper (``eval/swd.py``) and the
MS-SSIM mode-collapse readout (``eval/msssim.py``).  Neither needs a
pretrained network, and both run on the tensors' own device."""

from byogan_tpu_torch.eval.msssim import msssim, msssim_diversity
from byogan_tpu_torch.eval.swd import sliced_wasserstein_distance, swd_summary

__all__ = [
    "msssim",
    "msssim_diversity",
    "sliced_wasserstein_distance",
    "swd_summary",
]
