"""Instance metrics of the port."""
