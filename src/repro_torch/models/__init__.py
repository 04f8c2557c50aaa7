"""The LM substrate's models: dense GQA decoder stacks, their layers and
attention, and `build_model`."""
