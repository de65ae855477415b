"""InstructGS2GS (IG2G) fork layer of the port: text-driven scene editing.

Counterpart of ``gs2d_tpu/ig2g/``: InstructPix2Pix edits of the training
images on a cadence during 2DGS optimisation, the diffusion noise
initialised from the rasterizer's rendered-noise channel. The diffusion
math (``ops.py``), the SD-1.5 InstructPix2Pix UNet (``sdnet.py``), the
AutoencoderKL (``vae.py``), the CLIP text tower (``clip_text.py``) and its
BPE tokenizer (``tokenizer.py``) are plain PyTorch; the weights load from
a local diffusers snapshot through the port's own safetensors reader
(``sd_weights.py``, ``utils/safetensors.py``). The entry point is
``python -m gs2d_torch.cli.train_ig2g``. The edit metrics (``metrics.py``:
the CLIP score and directional similarity through the CLIP dual encoder
of ``clip_model.py`` and the preprocessing of ``clip_image.py``) and the
frequency analysis (``analysis.py``) sit beside the path.
"""
