"""Scale-out of one training run over several GPUs and hosts, on
``torch.distributed`` (counterpart of ``gs2d_tpu/parallel/``; the
reference is single-GPU)."""
