"""The plain reference of the benchmark: proximity-search records worked out
from the token table alone. It imports numpy and nothing of the program."""
