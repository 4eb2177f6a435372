"""The simulator half of the port: TeraPool topology, barrier schedules
and their padded level tables, the JAX-compatible PRNG, the plain and
degradation-tolerant simulator cores, the PE fault models, the Fig. 4a
sweep, the tuner and the Fig. 7 5G application."""
