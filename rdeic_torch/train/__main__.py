import sys

from rdeic_torch.train.cli import main

sys.exit(main())
