"""Models of the port: the dense GQA transformer LM (``transformer``) and
its layers (``layers``)."""
