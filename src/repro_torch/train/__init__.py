"""Step builders of the LM side (serving steps only, so far)."""
