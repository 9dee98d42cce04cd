"""The port's kernels and their plain versions.  Importing the package
registers the ops ``byogan::styleconv`` (K1) and ``byogan::noise_lrelu_adain``
(K2), which a loaded ``torch.export`` program calls (``deploy.py``)."""

from byogan_tpu_torch.ops import adain, styleconv  # noqa: F401  registers the two ops
