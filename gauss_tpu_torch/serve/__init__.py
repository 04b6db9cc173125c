"""The serving layer's pieces the structure router needs: shape buckets
(:mod:`.buckets`, a copy of the JAX package's) and the executable cache's
float32 LU lane (:mod:`.cache`). The server, the request journal, the
network tier and the lowered and spd lanes are ROADMAP queue-1 item 11.
Importing this package loads no torch."""
