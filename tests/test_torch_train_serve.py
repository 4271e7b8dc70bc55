"""An adapter trained by the port serves in both packages' engines.

Reduced qwen2-1.5b in fp32 on the reference's converted params: the port's
``Trainer`` takes a few NeuroAda steps, ``export_adapter`` writes the npz,
``repro.peft.load_adapter`` reads it, and the reference's paged engine and
the port's give the same greedy tokens with the trained adapter as a
tenant beside the base.
"""

import jax
import numpy as np
import torch

from repro.configs import get_config, reduced
from repro.models import get_model as j_get_model
from repro.peft import load_adapter as j_load_adapter
from repro.serve import AdapterStore as JStore
from repro.serve import ServeEngine as JEngine
from repro_torch.configs import PeftConfig, TrainConfig
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import reduced as t_reduced
from repro_torch.convert import tree_to_torch
from repro_torch.data import DataLoader
from repro_torch.models import get_model
from repro_torch.peft import export_adapter, get_peft, load_adapter
from repro_torch.serve import AdapterStore, ServeEngine
from repro_torch.train import Trainer
from repro_torch.tree import flatten

torch.set_num_threads(2)
NO_EOS = 1 << 20


def test_port_trained_adapter_serves_alike_in_both_engines(tmp_path):
    cfg = reduced(get_config("qwen2-1.5b")).replace(dtype="float32")
    jmodel = j_get_model(cfg)
    jparams = jmodel.init(jax.random.PRNGKey(2))
    tmodel = get_model(t_reduced(t_get_config("qwen2-1.5b")).replace(dtype="float32"))
    tparams = tree_to_torch(jax.tree.map(np.asarray, jparams))

    trainer = Trainer(tmodel, get_peft(PeftConfig(k=2)), TrainConfig(steps=4, learning_rate=3e-2),
                      tparams)
    data = DataLoader("reasoning", cfg.vocab_size, 4, 16, seed=1)
    try:
        hist = trainer.run(data)
    finally:
        data.close()
    assert len(hist) == 4 and all(np.isfinite(h["loss"]) for h in hist)
    vals = [v for _, v in flatten(trainer.state.trainable) if v is not None]
    assert all(v.dtype == torch.bfloat16 for v in vals)
    assert all(float(v.float().abs().max()) > 0 for v in vals)
    path = str(tmp_path / "tenant.npz")
    export_adapter(path, trainer.aux, trainer.state.trainable, {"arch": cfg.name})

    rng = np.random.default_rng(6)
    prompts = [rng.integers(3, cfg.vocab_size, size=n).tolist() for n in (5, 18, 9)]
    ids = [1, 0, 1]
    kw = {"slots": 2, "max_len": 48, "eos_id": NO_EOS, "prefill_chunk": 8}
    outs = []
    for engine, model, params, store, adapter, extra in (
            (JEngine, jmodel, jparams, JStore(), j_load_adapter(path), {"paged": True}),
            (ServeEngine, tmodel, tparams, AdapterStore(), load_adapter(path),
             {"device": "cpu"})):
        assert store.register(*adapter) == 1
        eng = engine(model, params, adapter_store=store, **extra, **kw)
        for p, aid in zip(prompts, ids):
            eng.submit(p, max_new=8, adapter_id=aid)
        outs.append([r.out for r in eng.run_to_completion()])
    assert outs[0] == outs[1]
    assert all(len(o) == 8 for o in outs[1])
