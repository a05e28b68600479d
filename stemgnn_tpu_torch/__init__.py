"""stemgnn_tpu_torch: the PyTorch + CUDA port of ``stemgnn_tpu`` for NVIDIA
Hopper (H100).

The JAX package stays the reference; this package mirrors its module names
(``core``, ``data``, ``ops``, ``nn``, ``vq``, ``train``, ``utils``) so each
counterpart is easy to find.  It imports ``torch`` and numpy only — never
``jax`` and nothing of ``stemgnn_tpu``.

Entry points run on ``cuda`` unless the caller asks for ``device="cpu"``;
without CUDA they raise instead of sliding to the CPU.  Every Pallas kernel
of a ported path is a hand-written CUDA kernel under ``csrc/``, built with
``nvcc`` at first use (``ops/scatter.py``); on CPU tensors each wrapper runs
its plain PyTorch version.

Ported so far: the minibatch pretrain, ``python -m
stemgnn_tpu_torch.pretrain`` (the neighbour sampler, the four losses, the
EMA teacher, checkpoints and resume); the serving path, ``python -m
stemgnn_tpu_torch.infer --mode encode`` (2-layer SAGE encoder + multi-head
cosine VQ, eval); and the full-batch node and link finetune, ``python -m
stemgnn_tpu_torch.finetune`` (frozen VQ, per-head decoder, forward and
backward through the kernels), which read the pretrain's checkpoints; and
the five robustness evaluations, ``python -m
stemgnn_tpu_torch.scripts.<name>`` (degree and homophily shift, missing
features, edge drops, the tri-objective) on ``eval/``.
"""
