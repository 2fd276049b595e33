"""The plain reference: NumPy and plain PyTorch, in float64 unless a
caller asks for less. It imports neither JAX, nor the JAX package, nor the
port, and takes nothing the port has made."""
