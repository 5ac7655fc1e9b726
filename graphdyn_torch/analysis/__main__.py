"""``python -m graphdyn_torch.analysis`` — run graftlint from the command
line."""

import sys

from graphdyn_torch.analysis.graftlint import main

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
