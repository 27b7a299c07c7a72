"""Entry points of the LM side (serving, so far)."""
