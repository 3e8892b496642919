"""Examples of the port, run as modules on the card:

    python -m zkvm_brainfuck_tpu_torch.examples.hello
    python -m zkvm_brainfuck_tpu_torch.examples.fibonacci

`--device cpu` runs the plain PyTorch versions of the kernels instead.
"""
