"""Fibonacci/multiplication example (reference: examples/fibonacci): the
README guest with stdin [17]; expected answer 85.  Counterpart of the JAX
package's examples/fibonacci.py.

    python -m zkvm_brainfuck_tpu_torch.examples.fibonacci [--device cpu]
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
    stdin = bytes([17])

    output = client.execute(guests.FIBO_BF, stdin).run()
    print("executed:", list(output))

    pk, vk = client.setup(guests.FIBO_BF)
    proof = client.prove(pk, stdin).run()
    client.verify(proof, vk)
    print("proved and verified; answer:", proof.public_values[0])


if __name__ == "__main__":
    main()
