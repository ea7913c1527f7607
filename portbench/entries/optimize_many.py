"""`zopfli_tpu_torch.png.optimize.optimize_many(pngs, PNGOptions(...))`,
one call for all the items, with the configuration's `options`: the
path the port's PNG command line takes."""


def entry(config: dict):
    from zopfli_tpu_torch.png.optimize import PNGOptions, optimize_many

    o = PNGOptions(**config.get("options", {}))
    return lambda items: optimize_many([i.raw for i in items], o)
