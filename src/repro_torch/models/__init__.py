"""Model families of the port: the dense GQA and MoE transformer
(``transformer``, ``moe``), RWKV6 (``rwkv``), the Mamba2 hybrid
(``mamba``), the enc-dec (``encdec``) and the VLM (``vlm``) on the
shared blocks (``common``, ``attention``) and ``config``."""
