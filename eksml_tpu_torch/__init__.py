"""PyTorch/CUDA port of ``eksml_tpu`` for NVIDIA Hopper (H100).

The JAX package ``eksml_tpu`` is the reference; this package computes
the same functions with PyTorch tensor code and hand-written CUDA
kernels (``csrc/``).  It imports neither JAX nor any module of
``eksml_tpu``: where it needs one of the reference's jax-free modules it
keeps its own copy.

Entry points (``Trainer``, ``python -m eksml_tpu_torch.train``,
``InferenceEngine``, ``OfflinePredictor``, ``ServingServer``,
``python -m eksml_tpu_torch.serve``) run on ``device="cuda"`` unless the
caller passes ``device="cpu"``; without a CUDA device they raise instead
of falling back.  On a GPU node ``python -m eksml_tpu_torch.launch``
starts one training rank per GPU (the ``charts/*-gpu`` charts run it).
"""
