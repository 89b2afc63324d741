"""kmeans_tpu_torch: the PyTorch / CUDA port of kmeans_tpu for NVIDIA Hopper.

``KMeans`` and its families ``MiniBatchKMeans``, ``BisectingKMeans`` and
``SphericalKMeans``, fit and predict through hand-written CUDA kernels
(``ops.hopper_kernels``), and ``GaussianMixture`` (all four covariance
types; the 'diag' and 'spherical' E-step is a hand-written CUDA kernel,
``ops.estep_kernels``), on one card or a ``torch.distributed`` mesh, from
data in memory or streamed block by block from files larger than the card
(``fit_stream`` and the inference streams; ``data.io``, ``data.prefetch``).
``ProductQuantizer`` trains m subspace codebooks in one device loop, and
``serving.ServingEngine`` holds fitted models resident and serves them
through the assignment kernels.  Imports ``torch`` and ``numpy`` only.
"""

__version__ = "0.1.0"

from kmeans_tpu_torch.models.bisecting import BisectingKMeans  # noqa: E402
from kmeans_tpu_torch.models.fault_tolerance import (  # noqa: E402
    NumericalDivergenceError)
from kmeans_tpu_torch.models.gmm import GaussianMixture  # noqa: E402
from kmeans_tpu_torch.models.kmeans import (  # noqa: E402
    DispatchLatencyHint, KMeans)
from kmeans_tpu_torch.models.minibatch import MiniBatchKMeans  # noqa: E402
from kmeans_tpu_torch.models.pq import ProductQuantizer  # noqa: E402
from kmeans_tpu_torch.models.spherical import SphericalKMeans  # noqa: E402
from kmeans_tpu_torch.parallel.mesh import make_mesh  # noqa: E402
from kmeans_tpu_torch.parallel.sharding import ShardedDataset  # noqa: E402
from kmeans_tpu_torch.sweep import SweepResult  # noqa: E402

__all__ = ["GaussianMixture", "KMeans", "MiniBatchKMeans", "BisectingKMeans",
           "SphericalKMeans", "ProductQuantizer", "DispatchLatencyHint",
           "NumericalDivergenceError", "ShardedDataset", "SweepResult",
           "make_mesh", "__version__"]
