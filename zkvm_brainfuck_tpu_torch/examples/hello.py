"""Hello example (reference: examples/hello/src/main.rs): prove + verify the
hello guest and print its output.  Counterpart of the JAX package's
examples/hello.py.

    python -m zkvm_brainfuck_tpu_torch.examples.hello [--device cpu]
"""

import argparse

from .. import ProverClient, guests, setup_logger


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None,
                        help="torch device; the CUDA card unless 'cpu' is given")
    args = parser.parse_args(argv)
    setup_logger()
    client = ProverClient(device=args.device)
    pk, vk = client.setup(guests.HELLO_BF)
    proof = client.prove(pk).run()
    client.verify(proof, vk)
    print("output:", proof.public_values.decode())


if __name__ == "__main__":
    main()
