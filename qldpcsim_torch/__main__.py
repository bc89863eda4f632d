"""`python -m qldpcsim_torch` entry point (the reference's
`python -m qldpcsim_tpu`)."""

import sys

from qldpcsim_torch.cli import main

if __name__ == "__main__":
    sys.exit(main())
