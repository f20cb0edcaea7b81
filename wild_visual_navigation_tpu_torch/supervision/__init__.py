"""Self-supervision from proprioception: the supervision generator."""
