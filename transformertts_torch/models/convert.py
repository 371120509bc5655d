"""Reference (TF/Keras) hdf5 weights → the JAX package's flat parameter
dict, for the ForwardTransformer: the port's own copy of what loading an
hdf5-only model dir needs from ``transformertts_tpu/models/convert.py``
(numpy only; h5py is imported by the readers, when a file is read).

Two on-disk layouts are handled:
- **Keras 3** ``.weights.h5``: nested groups by attribute path with ``vars/N``
  leaves (``convert_forward_weights``);
- **legacy Keras 2 hdf5** (the published ``bdf06b9_ljspeech`` artifacts and
  the JAX package's ``save_model(weights_format='hdf5')``): top-level groups
  per layer with ``weight_names`` attrs, mapped by creation order, names and
  shapes (``convert_legacy_weights``).

``read_forward_weights`` picks the layout from the file, as the JAX
package's ``load_reference_weights_into`` does, and returns the
``flatten_params`` dict (``'/'``-joined paths) that
``persistence.params_from_jax`` turns into a state dict.

Weight-layout facts the mapping relies on (reference model/layers.py):
Dense = (kernel(in,out), bias); Conv1D = (kernel(w,in,out), bias); LayerNorm =
(gamma, beta); the MHA output projection consumes ``concat([q, attention],
-1)``, so its kernel is (2·d, d); ``pos_encoding_scalar`` may be absent
(untracked in Keras 3) and defaults to 1.
"""
from typing import Dict

import numpy as np


# --------------------------------------------------------------- h5 readers

def _read_h5_flat(path) -> Dict[str, np.ndarray]:
    """Flatten any hdf5 weight file into {joined/path: array}."""
    import h5py
    flat = {}

    def walk(group, prefix=''):
        for key in group:
            item = group[key]
            if isinstance(item, h5py.Group):
                walk(item, f'{prefix}{key}/')
            else:
                flat[f'{prefix}{key}'] = np.asarray(item)

    with h5py.File(path, 'r') as f:
        # legacy layout: groups carry explicit weight_names attrs
        if 'layer_names' in f.attrs:
            for layer in f.attrs['layer_names']:
                layer = layer.decode() if isinstance(layer, bytes) else layer
                g = f[layer]
                names = [n.decode() if isinstance(n, bytes) else n
                         for n in g.attrs.get('weight_names', [])]
                for n in names:
                    flat[n.replace(':0', '')] = np.asarray(g[n])
        else:
            walk(f)
    return flat


def _sub(flat: Dict[str, np.ndarray], prefix: str) -> Dict[str, np.ndarray]:
    return {k[len(prefix):]: v for k, v in flat.items() if k.startswith(prefix)}


def _sorted_groups(flat: Dict[str, np.ndarray]):
    """Immediate child group names ordered by Keras auto-name suffix
    (``name`` < ``name_1`` < ``name_2`` …)."""
    names = {k.split('/', 1)[0] for k in flat if '/' in k}

    def order(n):
        parts = n.rsplit('_', 1)
        if len(parts) == 2 and parts[1].isdigit():
            return (parts[0], int(parts[1]))
        return (n, 0)

    return sorted(names, key=order)


# ---------------------------------------------------------- block assembly

def _dense(flat, prefix):
    p = {'kernel': flat[f'{prefix}vars/0']}
    if f'{prefix}vars/1' in flat:
        p['bias'] = flat[f'{prefix}vars/1']
    return p


def _ln(flat, prefix):
    return {'gamma': flat[f'{prefix}vars/0'], 'beta': flat[f'{prefix}vars/1']}


def _mha(flat, prefix):
    return {'wq': _dense(flat, f'{prefix}wq/'),
            'wk': _dense(flat, f'{prefix}wk/'),
            'wv': _dense(flat, f'{prefix}wv/'),
            'wo': _dense(flat, f'{prefix}dense/')}


def _sarn(flat, prefix):
    return {'mha': _mha(flat, f'{prefix}mha/'),
            'ln': _ln(flat, f'{prefix}last_ln/')}


def _ffn(flat, prefix):
    return {'d1': _dense(flat, f'{prefix}d1/'),
            'd2': _dense(flat, f'{prefix}d2/'),
            'ln': _ln(flat, f'{prefix}last_ln/')}


def _conv_stack(flat, prefix):
    """Reference CNNResNorm/CNNDropout: ``convolutions`` list + ``last_conv``
    (+ per-conv or single ``normalization``)."""
    sub = _sub(flat, prefix)
    convs = []
    conv_sub = _sub(sub, 'convolutions/')
    for g in _sorted_groups(conv_sub):
        convs.append(_dense(conv_sub, f'{g}/'))
    convs.append(_dense(sub, 'last_conv/'))
    norm_sub = _sub(sub, 'normalization/')
    if 'vars/0' in norm_sub:                 # single LN, no subgroup
        lns = [_ln(sub, 'normalization/')]
    elif norm_sub:
        lns = [_ln(norm_sub, f'{g}/') for g in _sorted_groups(norm_sub)]
    else:
        lns = []
    return convs, lns


def _cnn_resnorm(flat, prefix):
    convs, lns = _conv_stack(flat, prefix)
    p = {f'conv_{i}': c for i, c in enumerate(convs)}
    p['ln'] = lns[0]
    return p


def _cnn_dropout(flat, prefix):
    convs, lns = _conv_stack(flat, prefix)
    p = {f'conv_{i}': c for i, c in enumerate(convs)}
    p.update({f'ln_{i}': l for i, l in enumerate(lns)})
    return p


def _self_attention_blocks(flat, prefix):
    """Reference SelfAttentionBlocks → {ln, pos_encoding_scalar, dense_i,
    conv_i} (layers.py:267-310)."""
    sub = _sub(flat, prefix)
    p = {'ln': _ln(sub, 'layernorm/'),
         'pos_encoding_scalar': np.float32(
             sub.get('pos_encoding_scalar', 1.0))}
    sadb = _sub(sub, 'encoder_SADB/')
    for i, g in enumerate(_sorted_groups(sadb)):
        p[f'dense_{i}'] = {'sarn': _sarn(sadb, f'{g}/sarn/'),
                           'ffn': _ffn(sadb, f'{g}/ffn/')}
    sacb = _sub(sub, 'encoder_SACB/')
    for i, g in enumerate(_sorted_groups(sacb)):
        p[f'conv_{i}'] = {'sarn': _sarn(sacb, f'{g}/sarn/'),
                          'conv': _cnn_resnorm(sacb, f'{g}/conv/')}
    return p


def _stat_predictor(flat, prefix):
    return {'conv_blocks': _cnn_dropout(flat, f'{prefix}conv_blocks/'),
            'linear': _dense(flat, f'{prefix}linear/')}


# ------------------------------------------------------------- public API

def convert_forward_weights(flat: Dict[str, np.ndarray]) -> dict:
    """Keras-3-layout flat weights → ForwardTransformer param pytree."""
    # loose layers group: pitch_embed (Dense 1→d), out (Dense d→mel),
    # pitch_pred (StatPredictor) — Keras tracks unnamed attributes here
    layers = _sub(flat, 'layers/')
    dense_groups = [g for g in _sorted_groups(layers) if g.startswith('dense')]
    stat_groups = [g for g in _sorted_groups(layers)
                   if g.startswith('stat_predictor')]
    if any(k.startswith('pitch_pred/') for k in flat):
        pitch_pred = _stat_predictor(flat, 'pitch_pred/')
    else:
        pitch_pred = _stat_predictor(layers, f'{stat_groups[0]}/')
    if any(k.startswith('pitch_embed/') for k in flat):
        pitch_embed = _dense(flat, 'pitch_embed/')
        out = _dense(flat, 'out/')
    else:
        pitch_embed = _dense(layers, f'{dense_groups[0]}/')
        out = _dense(layers, f'{dense_groups[1]}/')
    return {
        'encoder_prenet': {'table': flat['encoder_prenet/vars/0']},
        'encoder': _self_attention_blocks(flat, 'encoder/'),
        'decoder': _self_attention_blocks(flat, 'decoder/'),
        'dur_pred': _stat_predictor(flat, 'dur_pred/'),
        'pitch_pred': pitch_pred,
        'pitch_embed': pitch_embed,
        'out': out,
    }


# ------------------------------------------------- legacy Keras-2 layout

def read_legacy_h5(path):
    """Legacy Keras-2 ``save_weights`` hdf5 → ordered per-layer weight lists.

    Layout: top-level attrs ``layer_names`` (model.layers in creation order);
    each group's attrs ``weight_names`` lists its variables in
    trainable-then-non-trainable creation order. Returns
    (groups, names, layer_names) where groups[i] is the ordered list of
    arrays of layer i. Weight datasets may live under nested subgroups
    (weight_names are slash-paths), so each name is resolved through h5py's
    path access.
    """
    import h5py
    groups, names, layer_names = [], [], []
    with h5py.File(path, 'r') as f:
        for layer in f.attrs['layer_names']:
            layer = layer.decode() if isinstance(layer, bytes) else layer
            g = f[layer]
            wnames = [n.decode() if isinstance(n, bytes) else n
                      for n in g.attrs.get('weight_names', [])]
            groups.append([np.asarray(g[n]) for n in wnames])
            names.append(wnames)
            layer_names.append(layer)
    return groups, names, layer_names


def _skel_dense(prefix):
    return [f'{prefix}/kernel', f'{prefix}/bias']


def _skel_ln(prefix):
    return [f'{prefix}/gamma', f'{prefix}/beta']


def _skel_mha(prefix):
    # reference creation order: wq, wk, wv, (attention: no weights), dense=wo
    # (model/layers.py:116-120)
    return (_skel_dense(f'{prefix}/wq') + _skel_dense(f'{prefix}/wk')
            + _skel_dense(f'{prefix}/wv') + _skel_dense(f'{prefix}/wo'))


def _skel_sarn(prefix):
    return _skel_mha(f'{prefix}/mha') + _skel_ln(f'{prefix}/ln')


def _skel_ffn(prefix):
    return (_skel_dense(f'{prefix}/d1') + _skel_dense(f'{prefix}/d2')
            + _skel_ln(f'{prefix}/ln'))


def _skel_conv_stack(prefix, n_convs, per_conv_ln):
    paths = []
    for i in range(n_convs):
        paths += _skel_dense(f'{prefix}/conv_{i}')
    if per_conv_ln:
        for i in range(n_convs):
            paths += _skel_ln(f'{prefix}/ln_{i}')
    else:
        paths += _skel_ln(f'{prefix}/ln')
    return paths


def _skel_self_attention_blocks(prefix, n_dense, n_conv, n_cnn_convs):
    # creation order (model/layers.py:267-296): pos scalar, SADB list,
    # SACB list, layernorm
    paths = [f'{prefix}/pos_encoding_scalar']
    for i in range(n_dense):
        paths += _skel_sarn(f'{prefix}/dense_{i}/sarn')
        paths += _skel_ffn(f'{prefix}/dense_{i}/ffn')
    for i in range(n_conv):
        paths += _skel_sarn(f'{prefix}/conv_{i}/sarn')
        paths += _skel_conv_stack(f'{prefix}/conv_{i}/conv', n_cnn_convs,
                                  per_conv_ln=False)
    paths += _skel_ln(f'{prefix}/ln')
    return paths


def _skel_stat_predictor(prefix, n_convs):
    return (_skel_conv_stack(f'{prefix}/conv_blocks', n_convs,
                             per_conv_ln=True)
            + _skel_dense(f'{prefix}/linear'))


def forward_legacy_skeleton(config: dict):
    """Per-layer ordered pytree paths, following ForwardTransformer's layer
    creation order (model/models.py:380-424): Embedding, Encoder, dur_pred,
    expand, pitch_pred, pitch_embed, Decoder, out."""
    n_enc_dense = int(config['encoder_dense_blocks'])
    n_dec_dense = int(config['decoder_dense_blocks'])
    n_enc_conv = len(config['encoder_num_heads']) - n_enc_dense
    n_dec_conv = len(config['decoder_num_heads']) - n_dec_dense
    n_attn_convs = len(config.get('encoder_attention_conv_filters') or [])
    return [
        ['encoder_prenet/table'],
        _skel_self_attention_blocks('encoder', n_enc_dense, n_enc_conv,
                                    n_attn_convs),
        _skel_stat_predictor('dur_pred',
                             len(config['duration_conv_filters'])),
        [],  # Expand: no weights
        _skel_stat_predictor('pitch_pred',
                             len(config['pitch_conv_filters'])),
        _skel_dense('pitch_embed'),
        _skel_self_attention_blocks('decoder', n_dec_dense, n_dec_conv,
                                    n_attn_convs),
        _skel_dense('out'),
    ]


# --- name-aware matching helpers ------------------------------------------
#
# The legacy format's contract is creation order, but weight_names carry
# three independent signals worth cross-checking (and exploiting when the
# order-based mapping would silently mis-assign same-shaped tensors):
#   1. the leaf kind (kernel/bias/gamma/beta/embeddings vs bare Variables),
#   2. Keras auto-name uids (dense_17 < dense_18 ⇒ creation order), and
#   3. block tags the reference passes explicitly (``Encoder_SADB_0``,
#      ``Decoder_CADB_last`` — reference model/layers.py:287,291,397,402).

_TENSOR_KINDS = ('kernel', 'bias', 'gamma', 'beta', 'embeddings')

# component name prefixes the reference assigns explicitly at model build
# (reference model/models.py:49-79,381-424) → our pytree roots
_LAYER_CLASSES = [
    ('embedding', 'encoder_prenet'), ('encoder', 'encoder'),
    ('decoderprenet', 'decoder_prenet'), ('decoder', 'decoder'),
    ('dur_pred', 'dur_pred'), ('pitch_pred', 'pitch_pred'),
    ('finalproj', 'final_proj_mel'), ('postnet', 'decoder_postnet'),
]


def _kind_of_path(path: str) -> str:
    leaf = path.rsplit('/', 1)[-1]
    if leaf in ('kernel', 'bias', 'gamma', 'beta'):
        return leaf
    if leaf == 'table':
        return 'embeddings'
    return 'scalar'  # pos_encoding_scalar


def _kind_of_name(name: str, arr) -> str:
    leaf = name.split('/')[-1].split(':')[0]
    base, _, suffix = leaf.rpartition('_')
    if suffix.isdigit() and base in _TENSOR_KINDS:
        leaf = base
    if leaf in _TENSOR_KINDS:
        return leaf
    if np.ndim(arr) == 0 or np.shape(arr) in ((), (1,)):
        return 'scalar'
    return 'unknown'


def _uid_tuple(name: str):
    """Per-component numeric auto-name suffixes, e.g.
    'Enc_SADB_1/multi_head_attention_3/dense_17/kernel:0' → (1, 3, 17)."""
    out = []
    for comp in name.split(':')[0].split('/'):
        base, _, suffix = comp.rpartition('_')
        out.append(int(suffix) if suffix.isdigit() else -1)
    return tuple(out)


def _base_pattern(name: str):
    """Name with auto-number suffixes stripped — two names are only
    uid-comparable when they live in structurally identical scopes."""
    out = []
    for comp in name.split(':')[0].split('/'):
        base, _, suffix = comp.rpartition('_')
        out.append(base if suffix.isdigit() else comp)
    return tuple(out)


def _block_tag(name: str):
    """(kind, index) from an explicit reference block tag in a weight name."""
    import re
    m = re.search(r'_(SADB|SACB|CADB)_(\d+|last)', name)
    if not m:
        return None
    idx = m.group(2)
    return m.group(1), (None if idx == 'last' else int(idx))


def _expected_block_tag(path: str):
    import re
    m = re.search(r'/(dense|conv|block)_(\d+)/', path)
    if not m:
        return None
    return {'dense': 'SADB', 'conv': 'SACB', 'block': 'CADB'}[m.group(1)], \
        int(m.group(2))


def _classify_layer_name(layer_name: str):
    """Explicit reference layer name → pytree root, or None if auto-named."""
    n = layer_name.lower()
    # exact-prefix match, longest first so 'decoderprenet' wins over 'decoder'
    for key, root in sorted(_LAYER_CLASSES, key=lambda kv: -len(kv[0])):
        if n == key or n.startswith(key + '_') or n == key.rstrip('_'):
            return root
    return None


def _align_groups(groups, names, layer_names, skeleton):
    """Pair checkpoint layer groups with skeleton groups.

    Weightless entries (Expand, Dropout wrappers) are dropped from both
    sides. Explicitly-named reference layers are matched by name — robust to
    layer-order permutations; auto-named layers (pitch_embed/out Denses) take
    the remaining skeleton slots in stored order.
    """
    names = names if names is not None else [[]] * len(groups)
    layer_names = (layer_names if layer_names is not None
                   else [''] * len(groups))
    ckpt = [(g, n, l) for g, n, l in zip(groups, names, layer_names) if g]
    skel = [[p for p in s if p != '__skip__'] for s in skeleton]
    skel = [s for s in skel if s]
    if len(ckpt) != len(skel):
        raise ValueError(
            f'layer-group count mismatch: checkpoint has {len(ckpt)} '
            f'non-empty groups ({[l for _, _, l in ckpt]}), expected '
            f'{len(skel)}')
    root_to_slot = {}
    for j, s in enumerate(skel):
        root_to_slot.setdefault(s[0].split('/', 1)[0], j)
    assigned = {}
    unmatched = []
    for i, (_, _, lname) in enumerate(ckpt):
        root = _classify_layer_name(lname)
        slot = root_to_slot.get(root) if root is not None else None
        if slot is not None and slot not in assigned.values():
            assigned[i] = slot
        else:
            unmatched.append(i)
    free = [j for j in range(len(skel)) if j not in assigned.values()]
    if len(free) != len(unmatched):
        raise ValueError('could not align checkpoint layers to components: '
                         f'{[ckpt[i][2] for i in unmatched]} vs slots {free}')
    for i, j in zip(unmatched, free):
        assigned[i] = j
    name_matched = set(assigned) - set(unmatched)
    return [(ckpt[i][0], ckpt[i][1], ckpt[i][2], skel[assigned[i]],
             'explicit-name' if i in name_matched else 'order-fallback')
            for i in range(len(ckpt))]


def _match_group(arrays, wnames, layer_name, paths, template_flat):
    """Assign a layer group's arrays to pytree paths.

    Primary key: per-kind partition (kernels with kernels, scalars with
    scalars) in stored order — immune to where non-trainable bare Variables
    (DecoderPrenet.rate) land. Cross-checks: shape chain against the model
    template, uid monotonicity within each kind, and explicit block tags.
    Extra bare scalars beyond what the skeleton expects are Keras bookkeeping
    Variables and are skipped.
    """
    have_names = bool(wnames) and len(wnames) == len(arrays)
    wnames = wnames if have_names else [''] * len(arrays)
    expected = {}   # kind -> [(path, shape)]
    for p in paths:
        shape = tuple(template_flat[p]) if (template_flat and
                                            p in template_flat) else None
        expected.setdefault(_kind_of_path(p), []).append((p, shape))
    actual = {}     # kind -> [(name, arr)]
    for nm, arr in zip(wnames, arrays):
        kind = _kind_of_name(nm, arr) if have_names else 'unknown'
        actual.setdefault(kind, []).append((nm, arr))

    if 'unknown' in actual:
        # uninformative names: fall back to pure stored-order zip
        if len(arrays) < len(paths):
            raise ValueError(
                f'weight count mismatch in {layer_name!r}: checkpoint '
                f'{len(arrays)} vs expected {len(paths)}')
        return list(zip(paths, arrays[:len(paths)]))

    out = []
    for kind, exp in expected.items():
        act = actual.pop(kind, [])
        if len(act) != len(exp):
            raise ValueError(
                f'{layer_name!r}: expected {len(exp)} {kind} weights, '
                f'checkpoint has {len(act)} '
                f'({[n for n, _ in act][:4]}…)')
        uids = [_uid_tuple(n) for n, _ in act]
        bases = [_base_pattern(n) for n, _ in act]
        for k in range(1, len(uids)):
            if (bases[k] == bases[k - 1] and uids[k] != uids[k - 1]
                    and max(uids[k]) >= 0 and uids[k] < uids[k - 1]):
                raise ValueError(
                    f'{layer_name!r}: {kind} weights stored out of creation '
                    f'order ({act[k - 1][0]} then {act[k][0]}); refusing an '
                    f'order-based mapping that would mis-assign them')
        last_block = max((t[1] for t in map(_expected_block_tag, paths)
                          if t is not None and t[0] == 'CADB'), default=None)
        for (p, _), (nm, _) in zip(exp, act):
            want, got = _expected_block_tag(p), _block_tag(nm)
            if got is not None and got[1] is None:
                got = (got[0], last_block)   # '_CADB_last' = highest index
            if want is not None and got is not None and want != got:
                raise ValueError(
                    f'{layer_name!r}: weight {nm} carries block tag {got} '
                    f'but maps to {p} (expected {want})')
        out.extend((p, arr) for (p, _), (_, arr) in zip(exp, act))
    leftover = {k: v for k, v in actual.items() if k != 'scalar' and v}
    if leftover:
        raise ValueError(f'{layer_name!r}: unconsumed weights {leftover}')
    return out


def convert_legacy_weights(groups, skeleton, template_flat=None, names=None,
                           layer_names=None) -> dict:
    """Ordered weight arrays → pytree, name-aware with shape verification.

    ``template_flat``: optional {path: shape} from an initialized model to
    verify every assignment (any ordering mistake breaks the shape chain).
    ``names``/``layer_names``: the hdf5 weight_names / layer_names attrs —
    used to classify layer groups, partition weights by kind, and detect
    mis-orderings that shapes alone cannot (wq/wk/wv are interchangeable).
    """
    tree = {}
    for arrays, wnames, lname, paths, _signal in _align_groups(
            groups, names, layer_names, skeleton):
        for path, arr in _match_group(arrays, wnames, lname, paths,
                                      template_flat):
            if template_flat is not None and path in template_flat:
                want = tuple(template_flat[path])
                got = tuple(np.shape(arr))
                if want != got and not (want == () and got in ((), (1,))):
                    raise ValueError(
                        f'shape mismatch at {path}: checkpoint {got}, '
                        f'model {want}')
            node = tree
            parts = path.split('/')
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = np.asarray(arr).reshape(
                template_flat[path] if template_flat and path in template_flat
                else np.shape(arr))
    return tree


def flatten(tree, prefix: str = '') -> Dict[str, np.ndarray]:
    """Nested parameter dict → ``{'/'-joined path: array}``, the JAX
    package's ``flatten_params`` layout."""
    if not isinstance(tree, dict):
        return {prefix[:-1]: np.asarray(tree)}
    flat = {}
    for key, value in tree.items():
        flat.update(flatten(value, f'{prefix}{key}/'))
    return flat


def read_forward_weights(path, config: dict,
                         template: Dict[str, tuple]) -> Dict[str, np.ndarray]:
    """A ForwardTransformer's hdf5 weights file → its ``flatten_params``
    dict. ``layer_names`` in the root attrs means the legacy Keras-2 layout,
    mapped onto ``forward_legacy_skeleton(config)`` with every assignment
    checked against ``template`` ({path: shape}); anything else is Keras 3."""
    import h5py
    with h5py.File(path, 'r') as f:
        legacy = 'layer_names' in f.attrs
    if not legacy:
        return flatten(convert_forward_weights(_read_h5_flat(path)))
    groups, names, layer_names = read_legacy_h5(path)
    return flatten(convert_legacy_weights(groups, forward_legacy_skeleton(config), template,
                                          names=names, layer_names=layer_names))
