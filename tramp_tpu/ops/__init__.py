"""Array operations shared by the channels (``dft``: FFT wrappers and the
packed-real spectral ops)."""
