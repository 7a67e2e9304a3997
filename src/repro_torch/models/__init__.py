"""Dense-transformer model code of the port (``Family.DENSE``/``AUDIO``)."""
