"""Operating constants.

These mirror the reference's fixed hyperparameters so output and behavior
stay contract-compatible (reference: memo_cli.py:17-18,
:245-247, :760, :810-811, :494, :133).
"""

# Embedding dimension of the hash bag-of-words embedder
# (reference memo_cli.py:17).
DIM = 384

# Hard cap on recall -k (reference memo_cli.py:18, clamp at :798-801).
MAX_K = 100

# Default recall k (reference memo_cli.py:760).
DEFAULT_K = 2

# Default analyze paging (reference memo_cli.py:810-811).
DEFAULT_ANALYZE_LIMIT = 100
DEFAULT_ANALYZE_OFFSET = 0

# Vestigial score cutoff kept for output parity: under L2 distances this
# branch never triggers (reference memo_cli.py:494; SURVEY.md §2.5 #2).
SCORE_SKIP_THRESHOLD = -0.9

# A vector with L2 norm at or below this is treated as zero
# (reference memo_cli.py:133).
NORM_EPSILON = 1e-8

# Index file magic for the versioned .memo-successor format (storage/index_io.py).
INDEX_MAGIC = b"TPUVDB01"
