"""The plain reference the benchmark judges the program by: secp256k1 on
Python integers, SHA-256 from hashlib, RIPEMD-160 in NumPy, Base58Check,
bech32 and bech32m, the share of addresses a pattern matches, and one
module per address format (``formats/``).  It imports nothing of the
program."""
