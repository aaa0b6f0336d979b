import sys

from .frontend.cli import main

sys.exit(main())
