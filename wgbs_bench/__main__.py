import sys

from wgbs_bench.run import main

if __name__ == "__main__":      # spawned pool workers import this module too
    sys.exit(main())
