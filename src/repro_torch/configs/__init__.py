"""Model configurations of the port: the LM family (``lm_family``)."""
