"""kmeans_tpu_torch: the PyTorch / CUDA port of kmeans_tpu for NVIDIA Hopper.

One card, float32: ``KMeans`` fit and predict through hand-written CUDA
kernels (``ops.hopper_kernels``), and ``GaussianMixture`` ('diag',
'spherical') whose E-step is a hand-written CUDA kernel
(``ops.estep_kernels``).  Imports ``torch`` and ``numpy`` only.
"""

__version__ = "0.1.0"

from kmeans_tpu_torch.models.gmm import GaussianMixture  # noqa: E402
from kmeans_tpu_torch.models.kmeans import KMeans  # noqa: E402

__all__ = ["GaussianMixture", "KMeans", "__version__"]
