"""KV page store: codecs (``quant``) and the page-table pool (``pages``)."""
