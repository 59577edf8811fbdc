"""Instance decoders of the port."""
