"""PyTorch/CUDA port of the FedDPC federated trainer.

A second package beside the JAX reference (``repro``), mirroring its tree
where that helps a reader find a module's counterpart. It imports
``torch`` and never ``jax`` or anything of ``repro``; the numpy-only host
modules it needs are its own copies.

Parameters live in ONE flat f32 buffer per model (``bridge.FlatLayout``),
laid out leaf by leaf in JAX's leaf order, so the server step is a pass
over a (K, N) stack of client deltas — carried on the card by the
hand-written kernels of ``kernels/feddpc_project``. The serving path
(``launch/serve.py``) runs the dense GQA decoders, every attention call
on the card through ``kernels/flash_attention``.

Entry points run on the card unless the caller asks for the CPU
(``device="cpu"``); they raise when CUDA is absent instead of falling
back.
"""
