"""PyTorch + CUDA port of byogan_tpu for one NVIDIA H100.

Training (``cli.main``, ``train/``, with the periodic SWD and MS-SSIM
eval of ``eval/``), sampling (``serve.Sampler``, ``cli.generate_samples``,
``cli.style_mix``, ``cli.interpolate``), W-space inversion and SeFa edits
(``projector.project``, ``editing``, ``cli.project``, ``cli.edit``) and
scoring (``cli.evaluate``) of the full progressive StyleGAN, with every
synthesis conv running through hand-written CUDA kernels: the forward
(``ops/styleconv.py``, ``ops/adain.py``) and the epilogue's backward
(``ops/styleconv_bwd.py``) inside autograd Functions.  Layouts
follow byogan_tpu at the public functions: NHWC activations, HWIO kernel
weights, parameters stored under the reference state-dict keys.

The package imports torch, numpy and the standard library only.  Entry
points run on ``cuda`` unless the caller asks for ``device="cpu"``; on a CPU
tensor every kernel wrapper takes its plain PyTorch version.
"""
