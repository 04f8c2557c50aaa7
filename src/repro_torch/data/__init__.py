"""Input batches of the LM substrate."""
