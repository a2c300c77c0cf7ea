"""Host seconds of building the model's weights from the raw block bytes
(`models.params.build_params`: the H2D, `native.decode`,
`pack_decoded`), ending in a synchronize."""


def read(run):
    return run.load_s
