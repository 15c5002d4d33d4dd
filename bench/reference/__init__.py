"""The plain reference the benchmark holds the system's answers against.

Plain PyTorch only: it imports nothing of the system under test, and works
out again from the raw fields what the system derived from them.
"""
