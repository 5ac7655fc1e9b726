"""``python -m graphdyn_torch <command> ...``"""

import sys

from graphdyn_torch.cli import main

if __name__ == "__main__":
    sys.exit(main())
