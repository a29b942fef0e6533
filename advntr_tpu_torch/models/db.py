"""SQLite model database — same schema as the reference so existing model
DBs drop in unchanged (reference: advntr/models.py:120-239, table
``vntrs(id, nonoverlapping, chromosome, ref_start, gene_name, annotation,
pattern, left_flanking, right_flanking, repeats, scaled_score)`` with repeat
segments comma-joined)."""

from __future__ import annotations

import os
import sqlite3

from advntr_tpu_torch.models.reference_vntr import ReferenceVNTR


def create_vntrs_database(db_file: str) -> None:
    parent = os.path.dirname(db_file)
    if parent and not os.path.exists(parent):
        os.makedirs(parent)
    db = sqlite3.connect(db_file)
    db.cursor().execute('''
    CREATE TABLE vntrs(id INTEGER PRIMARY KEY, nonoverlapping TEXT,
    chromosome TEXT, ref_start INTEGER, gene_name TEXT, annotation TEXT,
    pattern TEXT, left_flanking TEXT, right_flanking TEXT, repeats TEXT,
    scaled_score REAL default 0)
    ''')
    db.commit()
    db.close()


def load_unique_vntrs_data(db_file: str) -> list[ReferenceVNTR]:
    vntrs = []
    db = sqlite3.connect(db_file)
    cursor = db.cursor()
    cursor.execute('''SELECT id, nonoverlapping, chromosome, ref_start,
    gene_name, annotation, pattern, left_flanking, right_flanking, repeats,
    scaled_score FROM vntrs''')
    for row in cursor:
        row = [e if isinstance(e, (int, float)) else str(e) for e in row]
        (vntr_id, overlap, chrom, start, gene, annotation, pattern,
         left_flank, right_flank, segments, score) = row
        repeat_segments = segments.split(",") if "," in segments else []
        vntr = ReferenceVNTR(int(vntr_id), pattern, int(start), chrom, gene,
                             annotation, len(repeat_segments),
                             scaled_score=score)
        vntr.init_from_loaded(repeat_segments, left_flank, right_flank)
        vntr.non_overlapping = overlap == "True"
        vntrs.append(vntr)
    db.close()
    return vntrs


def save_reference_vntr_to_database(ref_vntr: ReferenceVNTR,
                                    db_file: str) -> None:
    db = sqlite3.connect(db_file)
    segments = ",".join(ref_vntr.get_repeat_segments())
    non_overlapping = "True" if ref_vntr.non_overlapping else "False"
    db.cursor().execute(
        '''INSERT INTO vntrs(id, nonoverlapping, chromosome, ref_start,
        gene_name, annotation, pattern, left_flanking, right_flanking,
        repeats, scaled_score) VALUES(?,?,?,?,?,?,?,?,?,?,?)''',
        (ref_vntr.id, non_overlapping, ref_vntr.chromosome,
         ref_vntr.start_point, ref_vntr.gene_name, ref_vntr.annotation,
         ref_vntr.pattern, ref_vntr.left_flanking_region,
         ref_vntr.right_flanking_region, segments, ref_vntr.scaled_score))
    db.commit()
    db.close()


def update_trained_score_in_database(vntr_id: int, scaled_score: float,
                                     db_file: str) -> None:
    db = sqlite3.connect(db_file)
    db.cursor().execute('UPDATE vntrs SET scaled_score=? WHERE id=?',
                        (scaled_score, vntr_id))
    db.commit()
    db.close()


def update_gene_name_and_annotation_in_database(vntr_id: int, gene_name: str,
                                                annotation: str,
                                                db_file: str) -> None:
    db = sqlite3.connect(db_file)
    db.cursor().execute(
        'UPDATE vntrs SET gene_name=?, annotation=? WHERE id=?',
        (gene_name, annotation, vntr_id))
    db.commit()
    db.close()


def get_largest_id_in_database(db_file: str) -> int:
    db = sqlite3.connect(db_file)
    cursor = db.cursor()
    cursor.execute('SELECT MAX(id) FROM vntrs')
    result = 0
    for row in cursor:
        if row[0] is not None:
            result = row[0]
    db.close()
    return result


def delete_vntr_from_database(vntr_id: int, db_file: str) -> None:
    db = sqlite3.connect(db_file)
    db.cursor().execute('DELETE FROM vntrs WHERE id=?', (vntr_id,))
    db.commit()
    db.close()
