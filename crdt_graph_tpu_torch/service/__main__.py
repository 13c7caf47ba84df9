import sys

from .http import serve

serve(int(sys.argv[1]) if len(sys.argv) > 1 else 8900)
