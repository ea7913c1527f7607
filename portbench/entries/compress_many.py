"""`zopfli_tpu_torch.compress_many(raws, format, Options(...))`, one call
for all the items, with the configuration's `format` and `options`."""


def entry(config: dict):
    import zopfli_tpu_torch as zt

    o = zt.Options(**config.get("options", {}))
    fmt = config["format"]
    return lambda items: zt.compress_many([i.raw for i in items], fmt, o)
