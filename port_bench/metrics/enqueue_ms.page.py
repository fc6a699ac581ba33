"""Self time (children excluded) of the page's launching stages under the
program's `page` roots, a page, in ms: `unet` (tiles, both U-Nets, the
blend), `geometry`, and the sheet query's `windows`, `encoder` and
`topk`; the host enqueueing the page's device work. The copies (`upload`),
the boxes' download with the unroll (`strip`) and the vote are not in it."""

from port_bench import spans


def read(run):
    if "pages" not in run.work:
        return None
    found = spans.under(run, "page")
    if found is None:
        return None
    within, n = found
    return spans.self_ms(within, ["unet", "geometry", "windows", "encoder",
                                  "topk"]) / n
