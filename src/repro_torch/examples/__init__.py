"""The paper's examples on the port (counterparts of the reference's
``examples/``), each run as ``python -m repro_torch.examples.<name>``: on
the card by default, ``--device cpu`` on the CPU."""
