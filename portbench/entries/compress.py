"""`zopfli_tpu_torch.compress(raw, format, Options(...))`, one call per
item, with the configuration's `format` and `options`."""


def entry(config: dict):
    import zopfli_tpu_torch as zt

    o = zt.Options(**config.get("options", {}))
    fmt = config["format"]
    return lambda items: [zt.compress(i.raw, fmt, o) for i in items]
