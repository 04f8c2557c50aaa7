"""The LM substrate's training and serving loops: the train state and
step, the pytree helpers they share with the optimizers and checkpoints,
and serving (prefill, cache hand-off, greedy decode)."""
