"""PyTorch/CUDA port of redgnn_tpu for NVIDIA Hopper (H100).

The JAX package ``redgnn_tpu`` is the reference this port is held
against; this package imports nothing from it, nor JAX. The layout
mirrors it module for module (``graph/``, ``ops/``, ``models/``,
``train/``, ``cli/``, ``utils/``, ``serve.py``). With
``segment_impl='pallas'`` the aggregation of every propagation hop,
sparse or dense, runs through the hand-written CUDA kernel in
``csrc/segment_sum_sorted.cu`` when its inputs lie on a CUDA device.

Entry points (``StaticKG.load``, ``InductiveKG.load``, ``RedGNN``,
``Predictor``, the
``cli.train`` command) run on ``cuda`` unless the caller passes
``device="cpu"``; a ``StaticTrainer`` runs on its KG's device.
"""
