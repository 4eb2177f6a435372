"""The simulator half of the port: TeraPool topology, barrier schedules
and their padded level tables, the JAX-compatible PRNG, the plain
simulator cores, the Fig. 4a sweep and the Fig. 7 5G application."""
