"""Model families of the port: the dense GQA and MoE transformer
(``transformer``, ``moe``), the enc-dec (``encdec``) and the VLM
(``vlm``) on the shared blocks (``common``, ``attention``) and
``config``."""
