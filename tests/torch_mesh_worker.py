"""The ranks of the PyTorch port's mesh tests.

`spawn` starts a world of processes joined by gloo (a file rendezvous
in a directory the caller owns, no TCP port) and runs one function of
this module on every rank; each rank's result comes back through a
pickle file. This module imports torch, numpy and the port only: a
spawned process imports the module its function lives in, and the test
modules import JAX.

The inputs (`train_case`, `op_inputs`, `serving_model`, ...) are built
from seeds, so that the parent computes the same thing without a mesh,
and with the JAX package, on the same numbers.
"""

import math
import os
import pickle

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from cor_asv_ann_tpu_torch.models import seq2seq as S
from cor_asv_ann_tpu_torch.models import train as T
from cor_asv_ann_tpu_torch.models.config import Seq2SeqConfig, init_params
from cor_asv_ann_tpu_torch.models.params import (params_from_numpy,
                                                 params_to_numpy,
                                                 tree_leaves, tree_map,
                                                 tree_unflatten)
from cor_asv_ann_tpu_torch.parallel import mesh as M
from cor_asv_ann_tpu_torch.utils.data import (CharMapping,
                                              vectorize_lines_indices)

CHARS = 'abcdefghij .,'
MAPPING = CharMapping.from_texts([CHARS + '\n'])


def spawn(world, target, tmp_dir, *args):
    """Run ``target(*args)`` (a function of this module) on `world` gloo
    ranks, one host thread each; returns the ranks' results in rank
    order."""
    tmp_dir = str(tmp_dir)
    os.makedirs(tmp_dir, exist_ok=True)
    saved = {k: os.environ.get(k) for k in _THREAD_VARS}
    os.environ.update({k: '1' for k in _THREAD_VARS})
    try:
        mp.start_processes(_rank_main, args=(world, target, tmp_dir, args),
                           nprocs=world, join=True, start_method='spawn')
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k)
            else:
                os.environ[k] = v
    results = []
    for rank in range(world):
        with open(os.path.join(tmp_dir, 'rank%d.pkl' % rank), 'rb') as f:
            results.append(pickle.load(f))
    return results


# read by numpy's BLAS when a spawned rank imports it
_THREAD_VARS = ('OMP_NUM_THREADS', 'OPENBLAS_NUM_THREADS', 'MKL_NUM_THREADS')


def _rank_main(rank, world, target, tmp_dir, args):
    torch.set_num_threads(1)
    dist.init_process_group(
        'gloo', init_method='file://' + os.path.join(tmp_dir, 'rendezvous'),
        rank=rank, world_size=world)
    try:
        result = globals()[target](*args)
    finally:
        dist.destroy_process_group()
    with open(os.path.join(tmp_dir, 'rank%d.pkl' % rank), 'wb') as f:
        pickle.dump(result, f)


# ---------------------------------------------------------------------
# inputs, the same in the parent and in the ranks

def train_config(dropout=0.0, width=32, mask_padding=False):
    return Seq2SeqConfig(width=width, depth=2, voc_size=MAPPING.voc_size,
                         dropout=dropout, mask_padding=mask_padding)


# (name, dropout, batch rows, what is special); the lines are sorted by
# length, so the shards of the data axis hold lines of unequal lengths
TRAIN_CASES = {
    'plain': dict(dropout=0.0, B=8),
    'dropout': dict(dropout=0.5, B=8),
    # the scans through lstm_scan_fused and the top layer through
    # teacher_top_fused_sharded (their plain twins on the CPU)
    'kernels': dict(dropout=0.5, B=8, flags='on'),
    # a padding mask: the encoder's masked scans through lstm_scan_fused
    # on each rank's rows and their own masks
    'masked_kernels': dict(dropout=0.5, B=8, flags='on', mask_padding=True),
    # weights that grow row by row: the shards' own mean losses differ
    # from the batch's even where the model's per-position loss does not
    'normalizer': dict(dropout=0.0, B=8, row_weights=True),
    # weights of 1e4: the largest gradients pass the clipnorm of 5, which
    # under a 'model' axis needs the full tensor's norm
    'clipped': dict(dropout=0.0, B=8, weight_scale=1e4),
    # every weight 0: the loss is the embedding regularizer alone
    'regularizer': dict(dropout=0.0, B=8, zero_weights=True),
    # a batch that no data axis of 2 divides: every rank holds it whole
    'indivisible': dict(dropout=0.0, B=7),
}


def train_case(name):
    """(config, params, batch) of one case: params from `init_params`,
    the batch in index form from seeded lines."""
    case = TRAIN_CASES[name]
    rng = np.random.default_rng(3)
    lengths = sorted(rng.integers(2, 14, case['B']))
    sources = [''.join(rng.choice(list(CHARS), n)) + '\n' for n in lengths]
    targets = [s.replace('a', 'b') for s in sources]
    batch = vectorize_lines_indices(MAPPING, sources, targets)
    if case.get('zero_weights'):
        batch = batch[:3] + (np.zeros_like(batch[3]),)
    if case.get('weight_scale'):
        batch = batch[:3] + (batch[3] * case['weight_scale'],)
    if case.get('row_weights'):
        rows = np.arange(1, case['B'] + 1, dtype=np.float32)[:, None]
        batch = batch[:3] + (batch[3] * rows,)
    config = train_config(case['dropout'],
                          mask_padding=case.get('mask_padding', False))
    return config, init_params(config, seed=1), batch


def keep_first_step_grads(opt, leaves):
    """A list that the first ``opt.step()`` fills with the gradients it
    applies (`train_step`'s, summed over 'data' and clipped), one tensor
    a leaf of `leaves` (a rank's slices under a mesh)."""
    kept = []

    def hook(optimizer, args, kwargs):
        if not kept:
            kept.extend(leaf.grad.detach().clone()
                        for leaf in tree_leaves(leaves))
    opt.register_step_pre_hook(hook)
    return kept


def full_tree(tree, config, mesh):
    """A rank's tree of parameter slices (or of their gradients) as the
    full tree in numpy, gathered over 'model' under a mesh."""
    if mesh is not None:
        with torch.no_grad():
            tree = M.gather_params(tree, T._full_shapes(config), mesh)
    return params_to_numpy(tree)


def run_train_step(name, mesh=None, compute=None, steps=1):
    """`steps` train_steps of a case (with `mesh`: the rank's part);
    returns the losses, the full parameters after them and the first
    step's clipped gradients of the full parameters, as numpy."""
    config, params, batch = train_case(name)
    flags = TRAIN_CASES[name].get('flags')
    leaves = (params_from_numpy(params, 'cpu') if mesh is None
              else M.shard_params(params, mesh))
    leaves = tree_map(lambda t: t.requires_grad_(), leaves)
    opt = T.make_optimizer(leaves)
    grads = keep_first_step_grads(opt, leaves)
    gen = torch.Generator().manual_seed(0)
    old = S._FUSED_SCAN, S._TEACHER_KERNEL
    if flags:
        S._FUSED_SCAN = S._TEACHER_KERNEL = flags
    try:
        losses = [float(T.train_step(leaves, opt, config, *batch, gen,
                                     compute_dtype=compute, mesh=mesh))
                  for _ in range(steps)]
    finally:
        S._FUSED_SCAN, S._TEACHER_KERNEL = old
    return (losses, full_tree(leaves, config, mesh),
            full_tree(tree_unflatten(params, grads), config, mesh))


def op_inputs():
    """The inputs of test_parallel.py's scan and teacher-kernel checks."""
    rng = np.random.default_rng(11)
    B, Tn, D, N = 16, 5, 8, 8
    scan = dict(
        w={'kernel': rng.normal(0, 0.4, (D, 4 * N)).astype(np.float32),
           'recurrent_kernel': rng.normal(0, 0.4, (N, 4 * N)).astype(
               np.float32),
           'bias': rng.normal(0, 0.1, (4 * N,)).astype(np.float32)},
        xs=rng.normal(0, 1, (B, Tn, D)).astype(np.float32))
    rng = np.random.default_rng(4)
    W = A = 128
    B, Td, Tn, ww = 8, 5, 16, 5

    def f(*s):
        return rng.normal(0, 0.18, s).astype(np.float32)

    top = {'W_a': f(W, W), 'v_a': f(W, 1), 'b_UW': f(W), 'b_v': f(1),
           'cell': {'kernel': f(W + A, 4 * W),
                    'recurrent_kernel': f(W, 4 * W), 'bias': f(4 * W)}}
    teacher = dict(top=top, xs=f(B, Td, W), att=f(B, Tn, A), u=f(B, Tn, W),
                   h0=f(B, W), c0=f(B, W), ww=ww)
    return scan, teacher


def scan_loss(out, hT, cT):
    return torch.sum(out.float() ** 2) + torch.sum(hT * cT)


def run_ops(mesh=None):
    """The scan (lstm_scan_fused) and the teacher layer
    (teacher_top_fused / _sharded) on the plain twins: forward, loss and
    the weight gradients, as numpy. With a mesh, as `train_step` runs
    them: the rank's rows and the full weights gathered from its slices
    over 'model', the gradients of the slices summed over 'data' and
    gathered."""
    from cor_asv_ann_tpu_torch.ops.lstm_scan_kernel import lstm_scan_fused
    from cor_asv_ann_tpu_torch.ops.teacher_kernel import (
        teacher_top_fused, teacher_top_fused_sharded)
    scan, teacher = op_inputs()
    out = {}

    def place(tree):
        """(the leaves to differentiate, the full weights to call with)"""
        if mesh is None:
            t = tree_map(lambda x: x.requires_grad_(),
                         params_from_numpy(tree, 'cpu'))
            return t, t
        t = tree_map(lambda x: x.requires_grad_(),
                     M.shard_params(tree, mesh))
        return t, M.gather_params(t, tree, mesh)

    def rows(*arrays):
        if mesh is None:
            return tuple(torch.from_numpy(a) for a in arrays), None
        return (M.shard_batch(arrays, mesh),
                mesh.local_rows(len(arrays[0])))

    def finish(key, fwd, loss, w, full, rows_):
        grads = torch.autograd.grad(loss, tree_leaves(w))
        if mesh is not None:
            grads = [mesh.sum_over(g.clone(), 'data') for g in grads]
            grads = tree_leaves(M.gather_params(
                grads, tree_leaves(full), mesh))
            fwd = M.gather_batch(fwd.detach(), mesh, rows_)
            loss = mesh.sum_over(loss.detach().reshape(1), 'data')[0]
        out[key] = dict(fwd=fwd.detach().numpy(), loss=float(loss.detach()),
                        grads=[g.numpy() for g in grads])

    w, full = place(scan['w'])
    (xs,), rows_ = rows(scan['xs'])
    hs, hT, cT = lstm_scan_fused(xs, full, mesh=mesh)
    finish('scan', hs, scan_loss(hs, hT, cT), w, scan['w'], rows_)

    top, full = place(teacher['top'])
    (xs, att, u, h0, c0), rows_ = rows(*(teacher[k] for k in
                                         ('xs', 'att', 'u', 'h0', 'c0')))
    if mesh is None:
        hs = teacher_top_fused(full, xs, att, u, h0, c0, None, teacher['ww'])
    else:
        hs = teacher_top_fused_sharded(full, xs, att, u, h0, c0, None,
                                       teacher['ww'], mesh)
    finish('teacher', hs, torch.sum(hs ** 2), top, teacher['top'], rows_)
    return out


SERVING_LINES = ["abba dig.\n", "chef gad.\n"] * 4


def serving_model():
    """test_parallel.py's serving model: w16/d2, a sharpened embedding."""
    from cor_asv_ann_tpu_torch.models.api import Sequence2Sequence
    s2s = Sequence2Sequence(device='cpu')
    s2s.width, s2s.depth, s2s.batch_size = 16, 2, 8
    s2s.mapping, _ = s2s.mapping.grow(["abcdefgh .,\n"])
    s2s.configure()
    s2s.params['char_embedding']['kernel'] = \
        s2s.params['char_embedding']['kernel'] * 400.0
    s2s.status = 2
    return s2s


def run_serving(mesh=None):
    """correct_lines of the serving model: greedy with scores, beam, and
    the 19-line multi-chunk case at batch size 9 (buckets of 9 lines,
    which no data axis of 2 divides, and of 8)."""
    s2s = serving_model()
    s2s.use_mesh(mesh if mesh is not None else False)
    out = {}
    lines, _, scores, aligns = s2s.correct_lines(SERVING_LINES, fast=True,
                                                 greedy=True)
    out['greedy'] = (lines, scores, aligns)
    out['beam'] = s2s.correct_lines(SERVING_LINES, fast=False,
                                    greedy=False)[0]
    s2s.batch_size = 9
    many = (SERVING_LINES * 3)[:19]
    lines, _, scores, _ = s2s.correct_lines(many, fast=True, greedy=True)
    out['many'] = (lines, scores)
    out['many_beam'] = s2s.correct_lines(many, fast=False, greedy=False)[0]
    return out


def decode_inputs():
    """test_sharded_decode_matches_single's model and batch."""
    mapping = CharMapping.from_texts(["abcdefgh .,\n"])
    config = Seq2SeqConfig(width=16, voc_size=mapping.voc_size)
    params = init_params(config, seed=3)
    params['char_embedding']['kernel'] *= 400.0
    lines = ["abba dig.\n"] * 8
    enc = np.zeros((len(lines), 12, mapping.voc_size), np.float32)
    for i, line in enumerate(lines):
        for j, ch in enumerate(line):
            enc[i, j, mapping.get(ch)] = 1.0
    return config, params, enc, mapping.get('\n')


def run_decode(mesh=None):
    """decode_greedy's indices: the whole batch, or under a mesh the
    rank's rows with the gathered weights, gathered over 'data'."""
    config, params, enc, newline = decode_inputs()
    if mesh is None:
        p = params_from_numpy(params, 'cpu')
        idx = S.decode_greedy(p, config, torch.from_numpy(enc), newline)[0]
        return idx.numpy()
    p = M.gather_params(M.shard_params(params, mesh), params, mesh)
    (enc_l,) = M.shard_batch((enc,), mesh)
    idx = S.decode_greedy(p, config, enc_l, newline)[0]
    return M.gather_batch(idx, mesh, mesh.local_rows(len(enc))).numpy()


def sharding_names(params, mesh):
    """`param_sharding`'s placements as 'R' / 'S<dim>' pairs, one
    string a leaf, in leaf order."""
    def name(p):
        return 'S%d' % p.dim if isinstance(p, M.Shard) else 'R'
    return tree_leaves(tree_map(lambda leaf, spec: ','.join(map(name, spec)),
                                params, M.param_sharding(params, mesh)))


def run_api_training(tmp_dir, mesh):
    """test_parallel.py::test_api_mesh_training: train() over the mesh
    end to end, then save (rank 0 writes)."""
    from cor_asv_ann_tpu_torch.models.api import Sequence2Sequence
    data = os.path.join(tmp_dir, 'train.tsv')
    pairs = [("abba dig.", "abba dig."), ("chef gad.", "chef gad."),
             ("hi fi.", "hi fi."), ("dig dag.", "dig dag.")] * 8
    if mesh.rank == 0:
        with open(data, 'w') as f:
            f.write(''.join('%s\t%s\n' % p for p in pairs))
    mesh.barrier()
    s2s = Sequence2Sequence(device='cpu')
    s2s.width, s2s.depth, s2s.batch_size, s2s.epochs = 8, 2, 8, 2
    s2s.configure()
    s2s.use_mesh(mesh)
    ckpt = os.path.join(tmp_dir, 'ckpt')
    if mesh.rank == 0:
        os.makedirs(ckpt)
    mesh.barrier()
    history = s2s.train([data], checkpoint_dir=ckpt)
    s2s.save(os.path.join(tmp_dir, 'mesh-model.h5'))
    mesh.barrier()
    return dict(history=history, status=s2s.status,
                files=sorted(os.listdir(tmp_dir)),
                ckpt_files=sorted(os.listdir(ckpt)),
                embedding=s2s.params['char_embedding']['kernel'])


def cpu_world(tmp_dir, data_axis=None):
    """Every check of one world shape, on the CPU (tests/
    test_torch_parallel.py holds the results against the single process
    and the JAX package)."""
    n = dist.get_world_size()
    res = {}
    for kw, key in (({'n_devices': n + 1}, 'bad_n_devices'),
                    ({'data_axis': n + 1}, 'bad_data_axis')):
        try:
            M.make_mesh(device='cpu', **kw)
        except ValueError as err:
            res[key] = str(err)
    mesh = M.make_mesh(-1, data_axis=data_axis, device='cpu')
    res['shape'] = dict(mesh.shape)
    res['batch_sharding'] = {b: ','.join(
        'S%d' % p.dim if isinstance(p, M.Shard) else 'R'
        for p in M.batch_sharding(mesh, b)) for b in (8, 7)}
    res['rank'] = (mesh.rank, mesh.data_index, mesh.model_index)
    big = Seq2SeqConfig(width=512, depth=2, voc_size=MAPPING.voc_size)
    res['placements'] = sharding_names(init_params(big), mesh)
    res['train'] = {name: run_train_step(name, mesh)
                    for name in TRAIN_CASES}
    res['ops'] = run_ops(mesh)
    res['decode'] = run_decode(mesh)
    res['serving'] = run_serving(mesh)
    res['api_training'] = run_api_training(tmp_dir, mesh)
    return res


# ---------------------------------------------------------------------
# on the card: two ranks share cuda:0 through gloo (NCCL refuses two
# ranks on one device); chip_smoke.py's mesh_path and
# tests/test_torch_cuda.py run these

KERNELS = ('lstm_scan_fwd', 'lstm_scan_bwd', 'teacher_fwd', 'teacher_bwd')


def kernel_launches():
    """The launch counts of K4-K7's wrappers."""
    from cor_asv_ann_tpu_torch.ops import lstm_scan_kernel as lsk
    from cor_asv_ann_tpu_torch.ops import teacher_kernel as tk
    return {'lstm_scan_fwd': lsk.lstm_scan_fwd.launches,
            'lstm_scan_bwd': lsk.lstm_scan_bwd.launches,
            'teacher_fwd': tk.teacher_fwd.launches,
            'teacher_bwd': tk.teacher_bwd.launches}


def card_step(config, params, batch, compute, device, mesh=None,
              timed_steps=0):
    """A train_step from `params` on `device` (with `mesh`: the rank's
    part), then `timed_steps` more steps timed from one synchronize to
    the next. Returns the first step's loss, the full parameters after
    it and its clipped gradients of the full parameters (numpy), the
    kernels' launches in the first step and the timed steps'
    milliseconds."""
    import time
    device = torch.device(device)
    leaves = (params_from_numpy(params, device) if mesh is None
              else M.shard_params(params, mesh))
    leaves = tree_map(lambda t: t.requires_grad_(), leaves)
    opt = T.make_optimizer(leaves)
    grads = keep_first_step_grads(opt, leaves)
    gen = torch.Generator().manual_seed(0)
    dtype = 'bfloat16' if compute == 'bfloat16' else None
    before = kernel_launches()
    loss = float(T.train_step(leaves, opt, config, *batch, gen,
                              compute_dtype=dtype, mesh=mesh))
    after = kernel_launches()
    host = full_tree(leaves, config, mesh)
    host_grads = full_tree(tree_unflatten(params, grads), config, mesh)
    ms = []
    for _ in range(timed_steps):
        if device.type == 'cuda':
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        float(T.train_step(leaves, opt, config, *batch, gen,
                           compute_dtype=dtype, mesh=mesh))
        ms.append((time.perf_counter() - t0) * 1e3)
    return dict(loss=loss, params=host, grads=host_grads, ms=ms,
                launches={k: after[k] - before[k] for k in KERNELS})


def serve_file(filename, lines, device, mesh=None, rejection=0.5):
    """Greedy and beam correct_lines of a model file (f32)."""
    from cor_asv_ann_tpu_torch.models.api import Sequence2Sequence
    s2s = Sequence2Sequence(device=device)
    s2s.load_config(filename)
    s2s.configure()
    s2s.load_weights(filename)
    s2s.rejection_threshold = rejection
    if mesh is not None:
        s2s.use_mesh(mesh)
    greedy = s2s.correct_lines(list(lines), return_alignments=False)
    beam = s2s.correct_lines(list(lines), fast=False, greedy=False,
                             return_alignments=False)
    return dict(greedy=greedy[0], greedy_scores=greedy[2], beam=beam[0])


def serving_agrees(got, want):
    """`serve_file` results equal in text, greedy scores within 1e-5
    (float32 sums over another batch's rows). Returns (ok, detail)."""
    diff = max(abs(a - b) for a, b in zip(got['greedy_scores'],
                                          want['greedy_scores']))
    texts = got['greedy'] == want['greedy'] and got['beam'] == want['beam']
    return texts and diff <= 1e-5, dict(texts_equal=texts,
                                        max_score_diff=diff)


def card_world(config, params, batch, computes, timed_steps=0, serve=None,
               device='cuda:0'):
    """On every rank: a mesh over the gloo world on `device` (all ranks
    on one card), `card_step` for each compute dtype and, with `serve` =
    (model file, lines), `serve_file` over the mesh."""
    from cor_asv_ann_tpu_torch.ops import _build
    device = torch.device(device)
    if device.type == 'cuda':
        _build.library()  # built by the parent: loaded, not compiled
    mesh = M.make_mesh(device=device)
    out = dict(shape=mesh.shape, backend=dist.get_backend(),
               steps={c: card_step(config, params, batch, c, device, mesh,
                                   timed_steps) for c in computes})
    if serve:
        out['serving'] = serve_file(*serve, device, mesh)
    return out


def card_case(B=32, seed=5):
    """A d2/w512 model without masked padding (its scans through K4/K5,
    its top layer through K6/K7), dropout 0.2, and a batch of B random
    lines of 8-40 characters."""
    rng = np.random.default_rng(seed)
    config = Seq2SeqConfig(width=512, depth=2, voc_size=MAPPING.voc_size,
                           dropout=0.2)
    lengths = rng.integers(8, 40, B)
    sources = [''.join(rng.choice(list(CHARS), n)) + '\n' for n in lengths]
    targets = [s.replace('a', 'b') for s in sources]
    return (config, init_params(config, seed=1),
            vectorize_lines_indices(MAPPING, sources, targets))


def grads_agree(got, want, rtol):
    """The largest gradient error of a step against another's, leaf by
    leaf: |got - want| over rtol * (|want| + 1e-3 |all of want|) in the
    2-norm (the floor keeps a leaf whose gradient is zero up to
    rounding, such as the attention's energy bias b_v, from counting its
    rounding as an error). 1 or less passes; a leaf's gradient summed
    twice gives about 1 / rtol."""
    a, b = tree_leaves(got), tree_leaves(want)
    whole = math.sqrt(sum(float(np.sum(np.square(x, dtype=np.float64)))
                          for x in b))
    return max(float(np.linalg.norm((x - y).ravel()))
               / (rtol * (float(np.linalg.norm(y.ravel())) + 1e-3 * whole))
               for x, y in zip(a, b))


def steps_agree(got, want, compute):
    """Whether a mesh step equals a single-process step at the port's
    bars: float32 loss rtol 1e-5, parameters rtol 1e-4 / atol 1e-5,
    clipped gradients (`grads_agree`) rtol 1e-4; bfloat16 loss rtol
    2e-2, 99% of the parameters within 1e-4 (a first Adam step moves
    every element by about the learning rate whatever its gradient's
    size, so an element whose bfloat16 gradient is at rounding noise may
    land elsewhere), gradients rtol 2e-2 (the first step's update shows
    a gradient's sign only, so the sizes are held here). Returns (ok,
    detail)."""
    a = np.concatenate([x.ravel() for x in tree_leaves(got['params'])])
    b = np.concatenate([x.ravel() for x in tree_leaves(want['params'])])
    diff = np.abs(a - b)
    loss_rel = abs(got['loss'] - want['loss']) / abs(want['loss'])
    grad_rtol = 1e-4 if compute == 'float32' else 2e-2
    grad_err = grads_agree(got['grads'], want['grads'], grad_rtol)
    if compute == 'float32':
        ok = loss_rel <= 1e-5 and bool(np.all(diff <= 1e-5 + 1e-4 * np.abs(b)))
    else:
        ok = loss_rel <= 2e-2 and float(np.mean(diff <= 1e-4)) >= 0.99
    ok = ok and grad_err <= 1.0
    return ok, dict(loss=got['loss'], want_loss=want['loss'],
                    loss_rel=loss_rel, max_param_diff=float(diff.max()),
                    share_within_1e4=float(np.mean(diff <= 1e-4)),
                    grad_err=grad_err, grad_rtol=grad_rtol)
