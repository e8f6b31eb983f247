"""Plain references of what the benchmark's cells compute: plain PyTorch,
no kernel, nothing of ``repro_torch`` (nor of ``jax`` or the JAX
package), and nothing the program made.  They are handed the inputs the
benchmark made (keys, counts, weights, hash parameters) and work every
derived quantity out again."""
