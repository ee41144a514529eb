"""``python -m`` entry point of the port's ``chunky-bits`` CLI."""

import sys

from chunky_bits_tpu_torch.cli.main import main

if __name__ == "__main__":
    sys.exit(main())
