"""Post-training tools of the port (``low_precision``)."""
