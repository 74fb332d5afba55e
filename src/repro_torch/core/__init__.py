"""The MIG-Serving layers the port needs, copied from the JAX package's
numpy-only ``repro.core``: performance profiles (:mod:`.profiles`), their
§8.3 online correction (:mod:`.online_profiles`) and the bridge from the
port's architectures to H100 MIG profiles (:mod:`.arch_bridge`)."""
