"""VNTR homology screening and the locus-homology graph (offline DB build).

Capability-equivalent to the reference's homologous-VNTR detection
(reference_vntr.py:72-78), its blat-based similar-region screen
(models.py:242-308 — replaced by the internal local aligner), and the
homology-graph construction (vntr_graph.py:42-56).
"""

from __future__ import annotations

from advntr_tpu_torch.ops.align import local_align


def vntr_structure(ref_vntr, margin: int = 20) -> str:
    return (ref_vntr.left_flanking_region[-margin:] + ref_vntr.pattern +
            ref_vntr.right_flanking_region[:margin])


def is_homologous_vntr(a, b) -> bool:
    """Two loci are homologous when their flank+motif structures locally
    align above 66% identity (reference: reference_vntr.py:72-78)."""
    s1, s2 = vntr_structure(a), vntr_structure(b)
    score, _, _ = local_align(s1, s2)
    return score / len(s1) > 0.66 or score / len(s2) > 0.66


def identify_homologous_vntrs(vntrs, chromosome=None):
    """Flag has_homologous on every pairwise-homologous locus
    (reference: models.py / identify_homologous_vntrs)."""
    for i in range(len(vntrs)):
        for j in range(i + 1, len(vntrs)):
            if chromosome and (chromosome != vntrs[i].chromosome and
                               chromosome != vntrs[j].chromosome):
                continue
            if is_homologous_vntr(vntrs[i], vntrs[j]):
                vntrs[i].has_homologous = True
                vntrs[j].has_homologous = True
    return vntrs


def find_similar_region_for_vntr(ref_vntr, reference_sequences: dict,
                                 margin: int = 30) -> bool:
    """True when the locus structure appears elsewhere in the reference with
    >75% identity — such loci are excluded from the default panels
    (capability of the reference's blat screen, models.py:242-275)."""
    query = (ref_vntr.left_flanking_region[-margin:] + ref_vntr.pattern +
             ref_vntr.right_flanking_region[:margin])
    threshold = 0.75 * (len(ref_vntr.pattern) + 2 * margin)
    own_chrom = ref_vntr.chromosome
    own_start = ref_vntr.start_point
    for chrom, seq in reference_sequences.items():
        score, start, end = local_align(seq, query)
        if score > threshold:
            if chrom == own_chrom and abs(start - own_start) < 10000:
                continue  # the locus itself
            return True
    return False


def vntr_graph(vntrs):
    """(nodes, edges) of the homology graph (vntr_graph.py:42-56)."""
    nodes = [v.id for v in vntrs]
    edges = []
    for i in range(len(vntrs)):
        for j in range(i + 1, len(vntrs)):
            if is_homologous_vntr(vntrs[i], vntrs[j]):
                edges.append((vntrs[i].id, vntrs[j].id))
    return nodes, edges


def plot_graph_components(nodes, edges, output_file_name="vntr_graph.png"):
    """Render the homology graph (requires networkx + matplotlib)."""
    import networkx as nx
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    G = nx.Graph()
    G.add_nodes_from(nodes)
    G.add_edges_from(edges)
    pos = nx.spring_layout(G, seed=0)
    nx.draw(G, pos, with_labels=False, node_size=100)
    plt.axis("off")
    plt.savefig(output_file_name)
