"""The repo's experiment tools on the port, one module per script of
``scripts/`` and with its name: ``python -m imm_tpu_torch.tools.<name>``.

- ``sweep_tps``: the runner over the variant registry
  ``scripts/sweep_variants.yaml`` (read in place);
- ``train_features``: trains the perceptual loss's VGG16 trunk as a U-Net
  denoiser's encoder and freezes it to an ``.npz``;
- ``oracle_floor``: the supervised ceilings of the synthetic harness;
- ``diagnose_landmarks``: the error decomposition of a sweep checkpoint.

Each runs on the GPU unless ``--device cpu`` is given, and writes its records
under ``docs/artifacts/torch/`` (or ``runs/``), never over the JAX package's.
"""
