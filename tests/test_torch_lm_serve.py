"""LM serving of the port against the JAX package's, on the CPU: the JSPIM
page table exactly, the greedy server's tokens wherever the logits' top-2
margin exceeds the logits tolerance (atol 1e-4 / rtol 1e-4, as in
``tests/test_torch_lm_models.py``), the CLI."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke as jsmoke
from repro.models import init_params as jinit_params
from repro.models import prefill as jprefill
from repro.serve import PageTable as JPageTable
from repro.serve import Server as JServer
from repro_torch.configs import smoke
from repro_torch.models import (decode_step, init_params,
                                params_from_reference, prefill)
from repro_torch.serve import PageTable, Server

KEY = jax.random.PRNGKey(0)


def test_page_table_alloc_lookup_free():
    """The reference's case (``tests/test_serve_data.py``)."""
    pt = PageTable(n_physical=16, max_pages_per_seq=4, device="cpu")
    phys = {(s, p): pt.alloc(s, p) for s in range(3) for p in range(2)}
    found, pages = pt.lookup(torch.tensor([0, 1, 2, 3]),
                             torch.tensor([1, 0, 1, 0]))
    assert found.tolist() == [True, True, True, False]  # seq 3 never
    for i, (s, p) in enumerate([(0, 1), (1, 0), (2, 1)]):
        assert int(pages[i]) == phys[(s, p)]
    pt.free_seq(1)
    found, _ = pt.lookup(torch.tensor([1]), torch.tensor([0]))
    assert not bool(found[0])


def test_page_pool_exhaustion():
    pt = PageTable(n_physical=2, max_pages_per_seq=4, device="cpu")
    pt.alloc(0, 0)
    pt.alloc(0, 1)
    with pytest.raises(RuntimeError, match="exhausted"):
        pt.alloc(0, 2)


def test_page_table_matches_reference_sequence():
    """A seeded alloc/free sequence on both packages: the same physical
    pages, the same lookups (found and payload), the same table planes,
    and a rebuild only after a change."""
    rng = np.random.default_rng(3)
    pt = PageTable(n_physical=300, max_pages_per_seq=16, device="cpu")
    jpt = JPageTable(n_physical=300, max_pages_per_seq=16)
    next_page = [0] * 24
    for step in range(400):
        seq = int(rng.integers(0, 24))
        if rng.random() < 0.1:
            pt.free_seq(seq)
            jpt.free_seq(seq)
            next_page[seq] = 0
        elif next_page[seq] < 16 and pt._free:
            assert pt.alloc(seq, next_page[seq]) == \
                jpt.alloc(seq, next_page[seq])
            next_page[seq] += 1
        if step % 100 == 99:
            seqs = np.repeat(np.arange(25), 17)
            pages = np.tile(np.arange(17), 25)
            found, pay = pt.lookup(torch.from_numpy(seqs),
                                   torch.from_numpy(pages))
            jfound, jpay = jpt.lookup(jnp.asarray(seqs), jnp.asarray(pages))
            np.testing.assert_array_equal(found.numpy(), np.asarray(jfound))
            np.testing.assert_array_equal(pay.numpy()[found.numpy()],
                                          np.asarray(jpay)[found.numpy()])
            for s, p in zip(seqs, pages):
                key = int(s) * 16 + int(p)
                assert bool(found[s * 17 + p]) == (key in pt._map)
            tbl = pt.table()
            np.testing.assert_array_equal(tbl.keys.numpy(),
                                          np.asarray(jpt.table().keys))
            np.testing.assert_array_equal(tbl.values.numpy(),
                                          np.asarray(jpt.table().values))
            assert pt.table() is tbl     # clean: no rebuild
    assert pt._map == jpt._map


@pytest.fixture(scope="module")
def musicgen():
    cfg, jcfg = smoke("musicgen-large"), jsmoke("musicgen-large")
    jp = jinit_params(jcfg, KEY)
    params = params_from_reference(jax.tree.map(np.asarray, jp), cfg, "cpu")
    prompts = jax.random.randint(KEY, (2, 8), 0, cfg.vocab_size)
    return cfg, jcfg, jp, params, prompts


def test_server_matches_reference_server(musicgen):
    """Greedy tokens equal JAX's wherever both packages' logits leave a
    top-2 margin above the tolerance; the first token is prefill's argmax;
    the pages are the reference server's."""
    cfg, jcfg, jp, params, prompts = musicgen
    steps = 6
    srv = Server(cfg, params, max_seq=32, batch=2, page_size=8,
                 device="cpu")
    seen = []
    step = srv.serve_step

    def recording(p, caches, tok, pos):
        logits, caches = step(p, caches, tok, pos)
        seen.append(logits.clone())
        return logits, caches
    srv.serve_step = recording
    res = srv.generate(torch.from_numpy(np.array(prompts)), steps=steps)
    jsrv = JServer(jcfg, jp, max_seq=32, batch=2, page_size=8)
    jres = jsrv.generate(prompts, steps=steps)
    assert res.tokens.shape == (2, steps) and res.steps == steps
    logits, _ = prefill(cfg, params, torch.from_numpy(np.array(prompts)),
                        max_seq=32)
    assert torch.equal(res.tokens[:, 0], torch.argmax(logits, dim=-1))
    jlogits, _ = jprefill(jcfg, jp, prompts, max_seq=32)
    np.testing.assert_array_equal(res.tokens[:, 0].numpy(),
                                  np.asarray(jnp.argmax(jlogits, axis=-1)))
    # token t+1 is the argmax of step t's logits; compare it with JAX's
    # where the port's top-2 margin clears the logits tolerance
    compared = 0
    for i in range(steps - 1):
        top2 = torch.topk(seen[i], 2, dim=-1).values
        margin = (top2[:, 0] - top2[:, 1]).numpy()
        ok = margin > 1e-4 + 1e-4 * np.abs(top2[:, 0].numpy())
        got = res.tokens[:, i + 1].numpy()
        want = np.asarray(jres.tokens[:, i + 1])
        np.testing.assert_array_equal(got[ok], want[ok])
        compared += int(ok.sum())
        if not ok.all():
            break     # past a near-tie the sequences may part
    assert compared >= steps - 1
    assert srv.pages._map == jsrv.pages._map


def test_server_page_bookkeeping_resolves_every_page():
    cfg = smoke("qwen3-4b")
    params = init_params(cfg, device="cpu")
    srv = Server(cfg, params, max_seq=32, batch=3, page_size=8,
                 device="cpu")
    srv.generate(torch.randint(0, cfg.vocab_size, (3, 10)), steps=12)
    # prompt pages 0-1, then pages 2 (pos 16) at step 6
    keys = sorted(srv.pages._map)
    assert len(keys) == 3 * 3
    seqs = torch.tensor([k // 4 for k in keys])
    pages = torch.tensor([k % 4 for k in keys])
    found, phys = srv.pages.lookup(seqs, pages)
    assert bool(found.all())
    assert phys.tolist() == [srv.pages._map[k] for k in keys]
    srv.pages.free_seq(1)
    found, _ = srv.pages.lookup(torch.tensor([1, 1, 0]),
                                torch.tensor([0, 2, 2]))
    assert found.tolist() == [False, False, True]


def test_server_rejects_params_on_another_device_and_bad_batch():
    cfg = smoke("qwen3-4b")
    params = init_params(cfg, device="meta")
    with pytest.raises(ValueError, match="parameters are on meta"):
        Server(cfg, params, max_seq=16, batch=2, device="cpu")
    srv = Server(cfg, init_params(cfg, device="cpu"), max_seq=16, batch=2,
                 device="cpu")
    with pytest.raises(ValueError, match="batch of 2"):
        srv.generate(torch.zeros(3, 4, dtype=torch.long), steps=1)


def test_server_past_max_seq_raises():
    """The reference clamps the write past its cache into the last slot
    (ROADMAP Queue 3); the port raises."""
    cfg = smoke("qwen3-4b")
    srv = Server(cfg, init_params(cfg, device="cpu"), max_seq=12, batch=2,
                 page_size=4, device="cpu")
    with pytest.raises(IndexError, match="outside the cache"):
        srv.generate(torch.zeros(2, 8, dtype=torch.long), steps=6)
    params = init_params(cfg, device="cpu")
    logits, caches = prefill(cfg, params, torch.zeros(2, 4,
                                                      dtype=torch.long),
                             max_seq=4)
    with pytest.raises(IndexError):
        decode_step(cfg, params, caches, torch.zeros(2, 1, dtype=torch.long),
                    4)


@pytest.mark.parametrize("arch", ["musicgen-large", "llama-3.2-vision-11b",
                                  "jamba-v0.1-52b"])
def test_serve_cli_on_cpu(arch, capsys):
    from repro_torch.launch.serve import main
    res = main(["--arch", arch, "--smoke", "--device", "cpu", "--batch", "2",
                "--prompt-len", "16", "--steps", "3"])
    assert res.tokens.shape == (2, 3)
    out = capsys.readouterr().out
    assert out.startswith("[serve] 2×3 tokens in ") and "pages=2" in out
