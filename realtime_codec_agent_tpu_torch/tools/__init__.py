"""Tools that run on the card beside the port (the HBM streaming probe)."""
