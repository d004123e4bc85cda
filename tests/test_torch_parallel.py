"""PyTorch port: the multi-device layer (parallel/mesh.py, training and
serving over a mesh) against one process and against the JAX package.

Each world runs in spawned processes joined by gloo on the CPU, all of
its checks in one spawn (tests/torch_mesh_worker.py): 2 ranks as (2, 1),
2 ranks with data_axis=1 as (1, 2), and 4 ranks as (2, 2) by the default
rule. The JAX side runs here, on the virtual CPU devices of
tests/conftest.py, over `make_mesh` of the same shape. Every test of
tests/test_parallel.py has its counterpart here under its own name.

Tolerances are test_parallel.py's: loss rtol 1e-5, parameters and
gradients rtol 1e-4 / atol 1e-5 (the teacher layer's gradients atol
1e-4); serving is equal in text, scores within 1e-5.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_mesh_worker as W
from cor_asv_ann_tpu.models import train as JT
from cor_asv_ann_tpu.models.config import Seq2SeqConfig as JConfig
from cor_asv_ann_tpu.parallel import mesh as JM
from cor_asv_ann_tpu_torch.models.train import embedding_regularizer
from torch_port_fixtures import single_threaded_cpu  # noqa: F401

# name -> (ranks, data_axis, mesh shape)
WORLDS = {'2x1': (2, None, (2, 1)), '1x2': (2, 1, (1, 2)),
          '2x2': (4, None, (2, 2))}
DATA_SHARDED = ['2x1', '2x2']


@pytest.fixture(scope='module')
def world(tmp_path_factory):
    """The ranks' results of a world, spawned once per module."""
    done = {}

    def get(name):
        if name not in done:
            ranks, data_axis, _ = WORLDS[name]
            tmp = tmp_path_factory.mktemp('world_' + name)
            done[name] = W.spawn(ranks, 'cpu_world', tmp, str(tmp),
                                 data_axis)
        return done[name]
    return get


@pytest.fixture(scope='module')
def single():
    """The same work in this process, without a mesh."""
    return dict(train={name: W.run_train_step(name)
                       for name in W.TRAIN_CASES},
                ops=W.run_ops(), decode=W.run_decode(),
                serving=W.run_serving())


def _jax_config(config):
    return JConfig(width=config.width, depth=config.depth,
                   voc_size=config.voc_size, dropout=config.dropout)


def jax_train_step(name, shape=None):
    """The JAX package's train_step on a case, over `make_mesh` of
    `shape` (data, model) or on one device: ([loss], the parameters
    after it, the clipped gradients it applied), as `run_train_step`
    returns them."""
    config, params, batch = W.train_case(name)
    config = _jax_config(config)
    opt = JT.make_optimizer(1e-3)
    p = jax.tree_util.tree_map(jnp.asarray, params)
    rng = jax.random.PRNGKey(0)

    def step(p, batch):
        # train_step's first transform is the per-tensor clipnorm
        grads = jax.grad(lambda q: JT.loss_fn(q, config, *batch, rng))(p)
        grads = JT.clip_per_tensor_norm(5.0).update(grads, None)[0]
        p, _, loss = JT.train_step(p, opt.init(p), config, *batch, rng,
                                   optimizer=opt)
        return loss, p, grads

    if shape is None:
        loss, p, grads = step(p, batch)
    else:
        mesh = JM.make_mesh(shape[0] * shape[1], data_axis=shape[0])
        p = JM.shard_params(p, mesh)
        if batch[0].shape[0] % shape[0] == 0:
            batch = JM.shard_batch(batch, mesh)
        else:
            batch = tuple(jax.device_put(a, JM.replicated(mesh))
                          for a in batch)
        with mesh:
            loss, p, grads = step(p, batch)
    host = functools.partial(jax.tree_util.tree_map, np.asarray)
    return [float(loss)], host(p), host(grads)


def assert_trees_close(got, want):
    for a, b in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(want)):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)


def assert_step_close(got, want):
    """One step's loss, updated parameters and the clipped gradients it
    applied, each ([loss], params, grads): the gradients are held too,
    since a first Adam step from zero moments moves each parameter by
    about the learning rate times its gradient's sign, whatever the
    gradient's size."""
    np.testing.assert_allclose(got[0][0], want[0][0], rtol=1e-5)
    assert_trees_close(got[1], want[1])
    assert_trees_close(got[2], want[2])


def assert_ranks_agree(ranks, key):
    """Every rank holds the same full result (within the step's bar: the
    ranks of a data row compute the replicated leaves alike)."""
    for r in ranks[1:]:
        for name in r[key]:
            assert_step_close(r[key][name], ranks[0][key][name])


@pytest.mark.parametrize('name', WORLDS)
def test_make_mesh_shapes(world, name):
    ranks, _, shape = WORLDS[name]
    res = world(name)
    for rank, r in enumerate(res):
        assert r['shape'] == {'data': shape[0], 'model': shape[1]}
        assert r['shape']['data'] * r['shape']['model'] == ranks
        assert r['rank'] == (rank, rank // shape[1], rank % shape[1])
        # a batch's rows go over 'data' where the data axis divides them
        assert r['batch_sharding'] == {
            8: 'S0,R', 7: 'S0,R' if shape[0] == 1 else 'R,R'}


def test_make_mesh_two_devices_prefers_data(world):
    """This workload scales in lines: a 2-rank mesh is pure data
    parallelism by default."""
    assert world('2x1')[0]['shape'] == {'data': 2, 'model': 1}


@pytest.mark.parametrize('name', WORLDS)
def test_make_mesh_bad_data_axis(world, name):
    """A data axis that does not divide the world, and a mesh size other
    than the world's (a rank cannot lend its device), raise ValueErrors
    that name both numbers."""
    n = WORLDS[name][0]
    res = world(name)[0]
    assert res['bad_data_axis'] == (
        'data_axis %d does not divide the %d available devices' % (n + 1, n))
    assert res['bad_n_devices'] == (
        'requested %d mesh devices but %d are available' % (n + 1, n))


@pytest.mark.parametrize('name', WORLDS)
def test_param_sharding_matches_jax(world, name):
    """The placements of a w512/d2 parameter tree equal the JAX
    package's PartitionSpecs leaf for leaf."""
    from cor_asv_ann_tpu.models.config import init_params as jinit
    n, data_axis, shape = WORLDS[name]
    params = jinit(JConfig(width=512, depth=2, voc_size=W.MAPPING.voc_size))
    mesh = JM.make_mesh(n, data_axis=shape[0])

    def names(sharding):
        spec = tuple(sharding.spec)
        model = ('S%d' % spec.index('model')) if 'model' in spec else 'R'
        return 'R,' + model

    want = [names(s) for s in
            jax.tree_util.tree_leaves(JM.param_sharding(params, mesh))]
    for r in world(name):
        assert r['placements'] == want
    if shape[1] > 1:
        assert 'R,S1' in want and 'R,S0' in want and 'R,R' in want


@pytest.mark.parametrize('name', WORLDS)
def test_mesh_train_step_matches_single_and_jax(world, single, name):
    """One f32 train_step over the mesh, shards of unequal line lengths:
    loss and updated parameters equal the single process's and the JAX
    package's train_step over a mesh of the same shape."""
    res = world(name)
    assert_step_close(res[0]['train']['plain'], single['train']['plain'])
    assert_step_close(res[0]['train']['plain'],
                      jax_train_step('plain', WORLDS[name][2]))
    assert_ranks_agree(res, 'train')


@pytest.mark.parametrize('name', DATA_SHARDED)
def test_loss_normalizer_is_global(world, single, name):
    """The loss divides by the global batch's count of weighted
    positions. The two shards hold lines of different lengths and
    weights, so the mean of the shards' own losses differs from the
    batch's loss; the mesh step gives the batch's."""
    from cor_asv_ann_tpu_torch.models import train as PT
    from cor_asv_ann_tpu_torch.models.params import params_from_numpy
    config, params, batch = W.train_case('normalizer')
    half = len(batch[3]) // 2
    assert (batch[3][:half] != 0).sum() != (batch[3][half:] != 0).sum()
    p = params_from_numpy(params, 'cpu')

    def data_loss(rows):
        return float(PT.eval_step(p, config, *(a[rows] for a in batch)))

    whole = data_loss(slice(None))
    shards = [data_loss(slice(0, half)), data_loss(slice(half, None))]
    assert abs(np.mean(shards) - whole) > 0.1 * whole
    got = world(name)[0]['train']['normalizer']
    assert_step_close(got, single['train']['normalizer'])
    assert_step_close(got, jax_train_step('normalizer', WORLDS[name][2]))


@pytest.mark.parametrize('name', WORLDS)
def test_clipnorm_takes_the_full_tensor_norm(world, single, name):
    """Gradients past the per-tensor clipnorm of 5: each is clipped by
    its full tensor's norm (summed over 'model' from the slices), after
    the sum over 'data', as one process and the JAX package clip it."""
    from cor_asv_ann_tpu_torch.models import train as PT
    from cor_asv_ann_tpu_torch.models.params import (params_from_numpy,
                                                     tree_leaves, tree_map)
    config, params, batch = W.train_case('clipped')
    p = tree_map(lambda t: t.requires_grad_(),
                 params_from_numpy(params, 'cpu'))
    loss = PT.loss_fn(p, config, *map(torch.as_tensor, batch), None)
    norms = [float(g.norm()) for g in
             torch.autograd.grad(loss, tree_leaves(p))]
    assert max(norms) > 5 and min(norms) < 5
    # a leaf that a 'model' axis of 2 shards is among the clipped ones
    specs = jax.tree_util.tree_leaves(JM.param_sharding(
        params, JM.make_mesh(2, data_axis=1)))
    assert max(n for n, s in zip(norms, specs)
               if 'model' in tuple(s.spec)) > 5
    got = world(name)[0]['train']['clipped']
    assert_step_close(got, single['train']['clipped'])
    assert_step_close(got, jax_train_step('clipped', WORLDS[name][2]))


@pytest.mark.parametrize('name', WORLDS)
def test_regularizer_counted_once(world, single, name):
    """With every weight 0 the loss is the embedding regularizer alone,
    once, not once a data shard; the update equals the single
    process's."""
    config, params, _ = W.train_case('regularizer')
    reg = float(embedding_regularizer(
        torch.from_numpy(params['char_embedding']['kernel'])))
    got = world(name)[0]['train']['regularizer']
    np.testing.assert_allclose(got[0][0], reg, rtol=1e-5)
    assert_step_close(got, single['train']['regularizer'])
    assert_step_close(got, jax_train_step('regularizer'))


@pytest.mark.parametrize('case', ['dropout', 'kernels', 'masked_kernels'])
@pytest.mark.parametrize('name', WORLDS)
def test_dropout_matches_single_process(world, single, name, case):
    """Dropout 0.5: every rank draws the global batch's masks from the
    same generator and keeps its rows, so the step equals the single
    process's with the same generator; 'kernels' sends the scans through
    lstm_scan_fused and the top layer through teacher_top_fused_sharded
    (their plain twins here), 'masked_kernels' a mask_padding model's
    scans through lstm_scan_fused with each rank's rows of the mask."""
    assert_step_close(world(name)[0]['train'][case], single['train'][case])


@pytest.mark.parametrize('name', WORLDS)
def test_indivisible_batch_is_replicated(world, single, name):
    """A 7-line batch: every rank holds it whole, nothing is summed over
    'data', and the step equals one process's and the JAX package's."""
    got = world(name)[0]['train']['indivisible']
    assert_step_close(got, single['train']['indivisible'])
    assert_step_close(got, jax_train_step('indivisible', WORLDS[name][2]))


@pytest.mark.parametrize('name', WORLDS)
def test_dryrun_multichip_consistency(world, single, name):
    """The counterpart of __graft_entry__.dryrun_multichip: a train step
    whose loss agrees with one process's, then greedy and beam serving
    equal to serving without a mesh."""
    res = world(name)[0]
    assert abs(res['train']['plain'][0][0]
               - single['train']['plain'][0][0]) < 1e-3
    assert res['serving']['greedy'][0] == single['serving']['greedy'][0]
    assert res['serving']['beam'] == single['serving']['beam']


@pytest.mark.parametrize('name', WORLDS)
def test_sharded_decode_matches_single(world, single, name):
    """decode_greedy on each rank's rows with the gathered weights,
    gathered over 'data', equals the unsharded decode and the JAX
    package's."""
    from cor_asv_ann_tpu.models.seq2seq import decode_greedy
    config, params, enc, newline = W.decode_inputs()
    jidx = np.asarray(decode_greedy(params, _jax_config(config), enc,
                                    newline)[0])
    for r in world(name):
        np.testing.assert_array_equal(r['decode'], single['decode'])
        np.testing.assert_array_equal(r['decode'], jidx)


@pytest.fixture(scope='module')
def jax_serving():
    """The JAX package's correct_lines on the serving model, unmeshed."""
    from cor_asv_ann_tpu.models.api import Sequence2Sequence
    s2s = Sequence2Sequence()
    s2s.width, s2s.depth, s2s.batch_size = 16, 2, 8
    s2s.mapping, _ = s2s.mapping.grow(["abcdefgh .,\n"])
    s2s.configure()
    s2s.params['char_embedding']['kernel'] = \
        s2s.params['char_embedding']['kernel'] * 400.0
    s2s.status = 2
    out = {}
    lines, _, scores, _ = s2s.correct_lines(W.SERVING_LINES, fast=True,
                                            greedy=True)
    out['greedy'] = (lines, scores)
    out['beam'] = s2s.correct_lines(W.SERVING_LINES, fast=False,
                                    greedy=False)[0]
    s2s.batch_size = 9
    many = (W.SERVING_LINES * 3)[:19]
    out['many'] = s2s.correct_lines(many, fast=True, greedy=True)[0]
    out['many_beam'] = s2s.correct_lines(many, fast=False, greedy=False)[0]
    return out


@pytest.mark.parametrize('name', WORLDS)
def test_api_use_mesh_serving(world, single, jax_serving, name):
    """use_mesh(): correct_lines is equal to serving without a mesh and
    to the JAX package's, greedy (texts, scores, alignments) and beam,
    including 19 lines in chunks of 9 and 8 (a bucket of 9 lines, which
    a data axis of 2 does not divide, is held whole by every rank)."""
    base = single['serving']
    for r in world(name):
        got = r['serving']
        assert got['greedy'][0] == base['greedy'][0]
        np.testing.assert_allclose(got['greedy'][1], base['greedy'][1],
                                   atol=1e-5)
        for a, b in zip(got['greedy'][2], base['greedy'][2]):
            np.testing.assert_allclose(a, b, atol=1e-5)
        assert got['beam'] == base['beam']
        assert got['many'][0] == base['many'][0]
        np.testing.assert_allclose(got['many'][1], base['many'][1],
                                   atol=1e-5)
        assert got['many_beam'] == base['many_beam']
    assert base['greedy'][0] == jax_serving['greedy'][0]
    np.testing.assert_allclose(base['greedy'][1], jax_serving['greedy'][1],
                               atol=1e-5)
    assert base['beam'] == jax_serving['beam']
    assert base['many'][0] == jax_serving['many']
    assert base['many_beam'] == jax_serving['many_beam']


def _assert_op_close(got, want, atol):
    np.testing.assert_allclose(got['loss'], want['loss'], rtol=1e-5)
    np.testing.assert_allclose(got['fwd'], want['fwd'], rtol=1e-5,
                               atol=1e-6)
    for a, b in zip(got['grads'], want['grads']):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=atol)


@pytest.mark.parametrize('name', WORLDS)
def test_fused_scan_shard_map_gradient_parity(world, single, name):
    """lstm_scan_fused(mesh=) on each rank's rows with the weights
    gathered over 'model': the forward, and the weight gradients summed
    over 'data', match the unsharded call."""
    for r in world(name):
        _assert_op_close(r['ops']['scan'], single['ops']['scan'], 1e-5)


@pytest.mark.parametrize('name', WORLDS)
def test_teacher_kernel_shard_map_parity(world, single, name):
    """teacher_top_fused_sharded: forward and summed weight gradients
    match the unsharded teacher_top_fused."""
    for r in world(name):
        _assert_op_close(r['ops']['teacher'], single['ops']['teacher'],
                         1e-4)


@pytest.mark.parametrize('name', WORLDS)
def test_api_mesh_training(world, name):
    """train() over the mesh runs end to end on every rank alike and
    produces a trained model that rank 0 alone saves."""
    res = world(name)
    first = res[0]['api_training']
    assert first['status'] == 2
    assert len(first['history']['loss']) >= 1
    assert np.isfinite(first['history']['loss'][-1])
    assert 'mesh-model.h5' in first['files']
    assert 'train_state.pkl' in first['ckpt_files']
    for r in res[1:]:
        assert r['api_training']['history'] == first['history']
        np.testing.assert_array_equal(r['api_training']['embedding'],
                                      first['embedding'])
