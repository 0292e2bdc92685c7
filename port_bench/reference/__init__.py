"""The plain reference: the model's mathematics in plain PyTorch, in
float32 with TF32 off, with no kernel, cache or batching of the port.
It imports nothing of the port; it takes the weights the benchmark
makes from the seed and the port's outputs, which it only judges."""
