"""Reference (TF/Keras) hdf5 weights ↔ the port's models, both ways: the
port's own copy of ``transformertts_tpu/models/convert.py`` (h5py is
imported by the readers and the writer, when a file is read or written, so
an npz model dir never needs it).

Two on-disk layouts are read, for the ForwardTransformer and the Aligner:
- **Keras 3** ``.weights.h5``: nested groups by attribute path with ``vars/N``
  leaves (``convert_forward_weights``, ``convert_aligner_weights``);
- **legacy Keras 2 hdf5** (the published ``bdf06b9_ljspeech`` artifacts and
  either package's ``save_model(weights_format='hdf5')``): top-level groups
  per layer with ``weight_names`` attrs, mapped by creation order, names and
  shapes (``convert_legacy_weights``).

``read_reference_weights`` picks the layout from the file, as the JAX
package's ``load_reference_weights_into`` does, and returns the
``flatten_params`` dict (``'/'``-joined paths) that
``persistence.params_from_jax`` turns into a state dict.
``write_legacy_h5`` writes the legacy layout from a model's state dict, so
the JAX package and the reference's TF ``load_weights`` read what the port
trained.

Weight-layout facts the mapping relies on (reference model/layers.py):
Dense = (kernel(in,out), bias); Conv1D = (kernel(w,in,out), bias); LayerNorm =
(gamma, beta); the MHA output projection consumes ``concat([q, attention],
-1)``, so its kernel is (2·d, d); ``pos_encoding_scalar`` may be absent
(untracked in Keras 3) and defaults to 1.
"""
from pathlib import Path
from typing import Dict

import numpy as np
import yaml

from transformertts_torch.models.persistence import (hdf5_weights, params_from_jax,
                                                     params_to_jax)


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


def _cross_attention_blocks(flat, prefix):
    """Reference CrossAttentionBlocks → {ln, pos_encoding_scalar, block_i}
    (layers.py:381-417: ``CADB`` list + ``layernorm``)."""
    sub = _sub(flat, prefix)
    p = {'ln': _ln(sub, 'layernorm/'),
         'pos_encoding_scalar': np.float32(
             sub.get('pos_encoding_scalar', 1.0))}

    def cadb_block(src, g):
        # CrossAttentionResnorm's LN is named ``layernorm``
        # (reference layers.py:313-328), unlike the self-attention resnorm
        return {'sarn': _sarn(src, f'{g}sarn/'),
                'carn': {'mha': _mha(src, f'{g}carn/mha/'),
                         'ln': _ln(src, f'{g}carn/layernorm/')},
                'ffn': _ffn(src, f'{g}ffn/')}

    cadb = _sub(sub, 'CADB/')
    groups = _sorted_groups(cadb)
    for i, g in enumerate(groups):
        p[f'block_{i}'] = cadb_block(cadb, f'{g}/')
    # the final block lives in its own attribute with no intermediate
    # group (layers.py:399-403)
    last = _sub(sub, 'last_CADB/')
    if last:
        p[f'block_{len(groups)}'] = cadb_block(last, '')
    return p


def convert_aligner_weights(flat: Dict[str, np.ndarray]) -> dict:
    """Keras-3-layout flat weights → Aligner param pytree."""
    layers = _sub(flat, 'layers/')
    dense_groups = [g for g in _sorted_groups(layers) if g.startswith('dense')]
    # final_proj_mel is the only loose Dense in the Aligner
    if any(k.startswith('final_proj_mel/') for k in flat):
        final_proj = _dense(flat, 'final_proj_mel/')
    else:
        final_proj = _dense(layers, f'{dense_groups[0]}/')
    prenet_prefix = ('decoder_prenet/' if any(
        k.startswith('decoder_prenet/') for k in flat) else 'DecoderPrenet/')
    postnet_prefix = ('decoder_postnet/' if any(
        k.startswith('decoder_postnet/') for k in flat) else 'Postnet/')
    return {
        'encoder_prenet': {'table': flat['encoder_prenet/vars/0']},
        'encoder': _self_attention_blocks(flat, 'encoder/'),
        'decoder': _cross_attention_blocks(flat, 'decoder/'),
        'decoder_prenet': {'d1': _dense(flat, f'{prenet_prefix}d1/'),
                           'd2': _dense(flat, f'{prenet_prefix}d2/')},
        'final_proj_mel': final_proj,
        'decoder_postnet': {
            'stop_linear': _dense(flat, f'{postnet_prefix}stop_linear/'),
            'mel_out': _dense(flat, f'{postnet_prefix}mel_out/')},
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


def _skel_cross_attention_blocks(prefix, n_blocks):
    # creation order (model/layers.py:381-403): pos scalar, CADB list,
    # last_CADB, layernorm; each CADB: sarn, carn, ffn
    paths = [f'{prefix}/pos_encoding_scalar']
    for i in range(n_blocks):
        paths += _skel_sarn(f'{prefix}/block_{i}/sarn')
        paths += _skel_mha(f'{prefix}/block_{i}/carn/mha')
        paths += _skel_ln(f'{prefix}/block_{i}/carn/ln')
        paths += _skel_ffn(f'{prefix}/block_{i}/ffn')
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


def aligner_legacy_skeleton(config: dict):
    """Aligner layer creation order (model/models.py:53-79): Embedding,
    Encoder, DecoderPrenet, Decoder, FinalProj, Postnet."""
    return [
        ['encoder_prenet/table'],
        _skel_self_attention_blocks(
            'encoder', len(config['encoder_num_heads']), 0, 0),
        # DecoderPrenet: d1, d2, then the non-trainable dropout-rate Variable
        (_skel_dense('decoder_prenet/d1') + _skel_dense('decoder_prenet/d2')
         + ['__skip__']),
        _skel_cross_attention_blocks(
            'decoder', len(config['decoder_num_heads'])),
        _skel_dense('final_proj_mel'),
        _skel_dense('decoder_postnet/stop_linear')
        + _skel_dense('decoder_postnet/mel_out'),
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


# ------------------------------------------------ readers into a model

FORWARD_LAYER_NAMES = ['Embedding', 'Encoder', 'dur_pred', 'expand',
                       'pitch_pred', 'dense', 'Decoder', 'dense_1']
ALIGNER_LAYER_NAMES = ['Embedding', 'Encoder', 'DecoderPrenet', 'Decoder',
                       'FinalProj', 'Postnet']


def _is_forward(model) -> bool:
    from transformertts_torch.models.forward_tts import ForwardTransformer
    return isinstance(model, ForwardTransformer)


def legacy_skeleton(model):
    """(per-layer ordered pytree paths, the reference's layer names) of
    ``model``'s class: the ForwardTransformer's or the Aligner's."""
    if _is_forward(model):
        return forward_legacy_skeleton(model.config), FORWARD_LAYER_NAMES
    return aligner_legacy_skeleton(model.config), ALIGNER_LAYER_NAMES


def _is_legacy(weights_path) -> bool:
    """``layer_names`` in the root attrs means the legacy Keras-2 layout."""
    import h5py
    with h5py.File(weights_path, 'r') as f:
        return 'layer_names' in f.attrs


def read_legacy_weights(model, weights_path) -> Dict[str, np.ndarray]:
    """A legacy Keras-2 hdf5 file → ``model``'s ``flatten_params`` dict, by
    the order+shape skeleton mapping; every assignment is checked against
    the model's own parameter shapes, so ordering errors fail loudly."""
    template = {k: v.shape for k, v in params_to_jax(model.state_dict()).items()}
    groups, names, layer_names = read_legacy_h5(weights_path)
    return flatten(convert_legacy_weights(groups, legacy_skeleton(model)[0], template,
                                          names=names, layer_names=layer_names))


def read_reference_weights(model, weights_path) -> Dict[str, np.ndarray]:
    """An hdf5 weights file of ``model`` (legacy Keras-2 or Keras-3 layout)
    → its ``flatten_params`` dict."""
    if _is_legacy(weights_path):
        return read_legacy_weights(model, weights_path)
    convert = convert_forward_weights if _is_forward(model) else convert_aligner_weights
    return flatten(convert(_read_h5_flat(weights_path)))


def load_legacy_weights_into(model, weights_path) -> None:
    """Fill ``model``'s parameters from a legacy Keras-2 hdf5 file."""
    model.load_state_dict(params_from_jax(read_legacy_weights(model, weights_path)),
                          strict=True)


def load_reference_weights_into(model, weights_path) -> None:
    """Fill ``model``'s parameters from a reference hdf5 weights file
    (legacy Keras-2 layout or Keras-3 ``.weights.h5``)."""
    model.load_state_dict(params_from_jax(read_reference_weights(model, weights_path)),
                          strict=True)


def load_reference_checkpoint(model_dir, device='cuda'):
    """A self-describing reference model dir (config.yaml + hdf5 weights:
    ``model_weights.hdf5``, else the first ``*.hdf5`` then ``*.h5``) → its
    ForwardTransformer on ``device`` (the card unless the caller names
    another)."""
    from transformertts_torch.models.forward_tts import ForwardTransformer
    model_dir = Path(model_dir)
    with open(model_dir / 'config.yaml') as f:
        config = yaml.safe_load(f)
    model = ForwardTransformer(**config)
    load_reference_weights_into(model, hdf5_weights(model_dir))
    model.step = int(config.get('step', 0))
    return model.to(device)


# ------------------------------------------------- legacy Keras-2 export

def write_legacy_h5(model, weights_path, include_bare_variables: bool = True) -> None:
    """Write ``model``'s parameters as a legacy Keras-2 ``save_weights`` hdf5.

    The inverse of :func:`load_legacy_weights_into`: layer groups follow the
    reference's layer creation order (model/models.py:380-424 forward,
    :53-79 aligner) with its explicit layer names, and each group's weights
    follow variable creation order, so the reference's TF ``load_weights``
    (which zips legacy groups in order) and the JAX package read it. The
    bare Variable the reference tracks but no model parameterizes
    (DecoderPrenet.rate) is written from ``decoder_prenet_dropout``.

    include_bare_variables: Keras 2 (the published artifacts) tracks bare
    ``tf.Variable`` attributes (pos_encoding_scalar, DecoderPrenet.rate) in
    layer.weights; Keras 3 does not. Pass False to target a Keras-3 TF
    consumer (its loaded model then keeps pos_encoding_scalar at 1.0).
    """
    import h5py
    flat = params_to_jax(model.state_dict())
    skeleton, layer_names = legacy_skeleton(model)
    with h5py.File(weights_path, 'w') as f:
        f.attrs['layer_names'] = [n.encode() for n in layer_names]
        f.attrs['backend'] = b'tensorflow'
        for lname, paths in zip(layer_names, skeleton):
            g = f.create_group(lname)
            wnames = []
            for p in paths:
                if not include_bare_variables and (
                        p == '__skip__' or p.endswith('/pos_encoding_scalar')):
                    continue
                if p == '__skip__':   # DecoderPrenet.rate, non-trainable
                    wname = f'{lname}/rate:0'
                    arr = np.float32(model.config.get('decoder_prenet_dropout', 0.5))
                elif p.endswith('/table'):   # Keras Embedding variable name
                    wname = f'{lname}/embeddings:0'
                    arr = flat[p]
                else:
                    wname = f'{lname}/{p.split("/", 1)[-1]}:0'
                    arr = flat[p]
                g[wname] = arr
                wnames.append(wname.encode())
            g.attrs['weight_names'] = wnames


def describe_weight_match(model, weights_path) -> list:
    """Per-layer match report for a reference hdf5 checkpoint:
    [(layer_name, skeleton_root, signal)] where signal is how the layer
    group was paired with model components: 'explicit-name' (matched by the
    checkpoint's layer_names attr), 'order-fallback' (took a free slot in
    stored order), or 'named-group' for the Keras-3 layout, whose h5 group
    paths are the names."""
    if not _is_legacy(weights_path):
        roots = sorted({k.split('/', 1)[0] for k in _read_h5_flat(weights_path)})
        return [(r, r, 'named-group') for r in roots]
    groups, names, layer_names = read_legacy_h5(weights_path)
    return [(lname, paths[0].split('/', 1)[0], signal)
            for _, _, lname, paths, signal in _align_groups(
                groups, names, layer_names, legacy_skeleton(model)[0])]
