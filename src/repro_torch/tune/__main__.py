import sys

from repro_torch.tune.cli import main

if __name__ == "__main__":
    sys.exit(main())
