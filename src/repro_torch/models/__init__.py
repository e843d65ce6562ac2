"""Model modules of the port: ``layers``, ``attention`` (GQA), ``moe``
(dense FFN), ``transformer`` (dense decoder) and ``model`` (the facade)."""
