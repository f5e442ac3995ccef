"""The plain reference the benchmark judges the program by: secp256k1 on
Python integers, SHA-256 from hashlib, RIPEMD-160 in NumPy, Base58Check,
and the share of addresses a pattern matches.  It imports nothing of the
program."""
