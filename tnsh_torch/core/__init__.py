"""Host core: RNG, serialization, transcript, parameters, proof I/O."""
