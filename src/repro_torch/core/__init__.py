"""Index format, query typing, the scalar engine and the torch serve steps."""
