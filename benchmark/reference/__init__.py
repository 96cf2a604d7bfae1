"""The plain reference: CLIP's forward in f32 and PQ scoring, in plain
PyTorch, importing nothing of the program. Frozen with the benchmark."""
