"""Engine core of the PyTorch/CUDA port: schemas, batches, plans, runtime."""
