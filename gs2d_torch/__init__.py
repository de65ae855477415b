"""gs2d_torch — the PyTorch/CUDA port of gs2d_tpu for NVIDIA Hopper (H100).

The JAX package ``gs2d_tpu`` is the reference; this package mirrors its
module paths and public names so each module's counterpart is easy to
find, and imports neither JAX nor anything of ``gs2d_tpu``.

Ported so far: the render path — camera → ``ops/rasterize/preprocess`` →
``ops/rasterize/binning`` → the hand-written CUDA forward compositing
kernel (``csrc/rasterize_fwd.cu``, wrapped by
``ops/rasterize/kernel_fwd.py``) → ``render/renderer.py`` — and the
training step (``train/step.py``): losses (``ops/ssim.py``), the backward
compositing kernel (``csrc/rasterize_bwd.cu``, wrapped by
``ops/rasterize/kernel_bwd.py``) behind the autograd boundary of
``ops/rasterize/api.py``, Adam (``train/optim.py``) and the densification
statistics (``models/densify.py``) — and the training loop
(``train/loop.py``): clone, split and prune (``models/densify.py``, every
row selection through the row-gather kernel ``csrc/gather_rows.cu``,
wrapped by ``ops/gather.py``), the opacity reset, model init
(``models/gaussians.py::init_from_pcd``, ``ops/knn.py``) and npz
checkpoints in the JAX package's schema (``models/io.py``) — and the data
path: COLMAP and Blender scenes on disk (``scene/``, with the port's own
PNG codec in ``scene/images.py``), TSDF meshing (``render/extract.py``,
``ops/tsdf.py``, ``ops/marching.py``) and the train, render and metrics
CLIs (``cli/``) — and the evaluation of the paper's benchmarks: JPEG
scenes (``scene/jpeg.py``, its Huffman decoder the host library
``csrc/jpeg_entropy.cpp``), LPIPS (``eval/lpips.py``), the DTU and Tanks
and Temples protocols (``eval/``) and their harnesses
(``cli/{m360,dtu,tnt}_eval.py``) — and the IG2G editing path
(``cli/train_ig2g.py``): the SD-1.5 InstructPix2Pix UNet, VAE and CLIP
text tower, the tokenizer, the weight loader and the editor
(``ig2g/``), with the port's own safetensors codec
(``utils/safetensors.py``) — and several GPUs on ``torch.distributed``
(``parallel/``: row bands per rank, the (gauss, data) grid, torchrun
bring-up) and the SIBR live viewer (``render/network_gui.py``,
``cli/view.py``). Entry points take a ``device`` argument that defaults to
``"cuda"``; on a CPU tensor each kernel wrapper runs its plain PyTorch
version instead.
"""

import torch as _torch

# Full-f32 numerics, the counterpart of gs2d_tpu forcing HIGHEST matmul
# precision: reduced-precision products shifted rendered images by ~4e-3
# there. Convolutions through cuDNN default to TF32 in PyTorch.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"
