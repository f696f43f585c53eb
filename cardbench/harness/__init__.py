"""The benchmark's machinery: data and traffic generation, the system under
test, the closed loop, the device trace, the judge of correctness and the
assembly of a run's result line. Nothing here imports JAX or the JAX
package; the port (``repro_torch``) is imported only by ``sut``."""
