"""Model families of the port: the dense GQA transformer (``transformer``)
on the shared blocks (``common``, ``attention``) and ``config``."""
