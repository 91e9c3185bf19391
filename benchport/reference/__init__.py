"""The benchmark's plain reference: RFC 8439 ChaCha20 in NumPy and Paillier
on Python ints.  It imports nothing of the measured program."""
