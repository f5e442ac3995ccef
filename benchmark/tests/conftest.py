import sys
from pathlib import Path

# the benchmark package and the program, from the repository's root
sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
