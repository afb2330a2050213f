"""The plain reference: the chain's semantics and Ed25519 in plain
Python. Nothing here imports the program."""
