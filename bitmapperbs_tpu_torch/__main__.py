import sys

from bitmapperbs_tpu_torch.cli import main

sys.exit(main())
