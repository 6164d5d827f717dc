import sys

from repro_torch.fleet.cli import main

if __name__ == "__main__":
    try:
        sys.exit(main())
    except BrokenPipeError:  # e.g. `... | head`: not an error
        sys.exit(0)
