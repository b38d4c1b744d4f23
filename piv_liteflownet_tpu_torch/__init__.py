"""piv_liteflownet_tpu_torch: the PyTorch/CUDA port of piv_liteflownet_tpu.

PIV-LiteFlowNet-en and LiteFlowNet, versions 1 and 2, inference and
training on an NVIDIA H100, with the trainer's command line
(``python -m piv_liteflownet_tpu_torch.trainer``) and its data path
(``data/``: synthetic particle pairs, datasets, loaders, and the
augmentation that runs on the card inside the train step). The model is PyTorch; the cost volume, the
feature backwarp, the fused rgb warp + occlusion norm, the backward of the
warp and of the cost volume, and the NetE conv chain are hand-written CUDA
kernels (``csrc/*.cu``, built with ``nvcc`` at first use, see
``kernels/build.py``). Entry points run on the CUDA card unless the caller
passes ``device="cpu"``. Over several cards, one process each
(``parallel/mesh.py``): data-parallel training and inference, and inference
with each frame's height split over the cards (``parallel/spatial.py``).
"""

__version__ = "0.1.0"

from piv_liteflownet_tpu_torch.models.factory import hui_liteflownet, piv_liteflownet  # noqa: F401
