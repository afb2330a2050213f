"""The command line (``python -m cometbft_tpu_torch``)."""
