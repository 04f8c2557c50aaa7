"""The LM substrate's serving loop (prefill, cache hand-off, greedy
decode)."""
