"""The plain reference: a decoder written in plain PyTorch from the model's
equations, in float32 with TF32 off, that imports nothing of the program.
It reads the weights the benchmark drew (``mrabench.weights``), never the
program's state, and works out everything else again."""
